"""A copy of the benchmark in a temporary directory, with a cell small
enough for the CPU, for the tests of portbench."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.registry import PKG, REPO, copy_with_cell

TINY = "tiny.tail3"

# an x4 stage at narrow widths: 23 blocks, as the program's checkpoint
# loader builds them, 8 features, 4 growth channels; on a 16x9 frame the
# program runs it whole.  Sound runs read 0 here (the program's network
# is the reference's arithmetic on the CPU); the bfloat16 control and the
# stage's faults read 45-100% (u8 values spread by 23 about 129 at gain
# 0.3).
UPSCALE = {"arch": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3,
           "num_feat": 8, "num_block": 23, "num_grow_ch": 4, "scale": 4,
           "tile": 128, "overlap": 8,
           "weights": {"init": "he_normal", "gain": 0.3,
                       "conv_last_bias": 0.5},
           "driver_flags": ["--upscale", "--upscale_weights", "{weights}"],
           "output_suffix": "_upscaled",
           "check": {"frames": 2, "tiles": 4,
                     "limits": {"up_mismatch_pct": 5.0}}}


def make(tmp: Path, width: int = 64, height: int = 36, spp: int = 6,
         chunk_spp: int = 2, window_poses=(96, 99),
         upscale: dict | None = None, files: dict | None = None) -> Path:
    """BENCHMARK.json and portbench's data under `tmp`, plus the config
    `tiny` (the detail-1 stand-in at width x height, spp in chunks of
    chunk_spp, with the `upscale` block where one is given), the mix
    `tail3` (poses [window_poses)), as cell tiny.tail3, and `files`
    ({path under portbench: text}): all of it files added to a copy."""
    cfg = json.loads((REPO / PKG / "configs" /
                      "rdv_b_1080p_1000spp.json").read_text())
    cfg.update(name="tiny", width=width, height=height, spp=spp,
               standin_detail=1, dispatch_rays=width * height * chunk_spp)
    # the cell's own limit at this size: sound runs read 0 here (the
    # program's plain version is the reference's arithmetic), and at 6
    # samples the control and the faults read 39-100%
    cfg["check"].update(frames=2, candidates=1024, lit_pixels=24, any_pixels=4,
                        limits={"frames_missing": 0, "px_mismatch_pct": 5.0})
    if upscale:
        cfg["upscale"] = upscale
    first, stop = window_poses
    return copy_with_cell(tmp, cfg, "tail3",
                          {"poses": "data/poses99.txt", "first": first,
                           "stop": stop, "stride": 1, "repeat": 1},
                          TINY, "rdv_b.close6", files)
