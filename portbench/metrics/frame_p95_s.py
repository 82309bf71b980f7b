"""frame_p95_s: 95th percentile, over every frame of the window, of the
wait for its PNG: from the previous PNG of the same call, or from the
call's start for its first frame (file modification times)."""

import numpy as np


def read(run):
    waits = [f.wait_s for f in run.frames if f.wait_s is not None]
    return float(np.percentile(waits, 95)) if waits else None
