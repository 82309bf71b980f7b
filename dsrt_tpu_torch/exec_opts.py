"""Runtime execution options of the port (port of dsrt_tpu/exec_opts.py,
the one knob the split pipeline reads).

`fused_sun`: fuse the sun-shadow any-hit into the closest-hit traversal
(ops/traverse.traverse_with_sun, one `dsrt_traverse_sun` launch per wave
instead of two `dsrt_traverse` launches) on scenes of triangles only.  It
shadows every hit lane, not just the potential receivers, so it pays off
only where most hits are diffuse receivers.  Off by default; DSRT_FUSED_SUN=1
turns it on at import, and tests set OPTS.fused_sun directly.  Either
setting gives the same images up to the shadow origin's normal (the
kernel's geometric normal instead of the stored face normal).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class ExecOptions:
    fused_sun: bool = os.environ.get("DSRT_FUSED_SUN", "0") == "1"


OPTS = ExecOptions()
