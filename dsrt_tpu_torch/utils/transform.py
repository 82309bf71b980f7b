"""Double-precision world->model frame transforms (host-side).

A copy of dsrt_tpu/utils/transform.py: the port imports nothing of the JAX package.

The reference's entire "deep-space double precision" subsystem is a small
f64 vector kit applied on the CPU before anything reaches the GPU
(src/main.cpp:55-128, 306-385).  The same design is the right one on TPU —
f64 stays on the host in NumPy; the device only ever sees model-frame f32 —
so this module is deliberately tiny and NumPy-float64.

Conventions (verbatim from the reference):
- world frame origin = the light (Sun);
- model rotation approximated by yaw about +Y, right-handed, positive yaw
  rotates +Z toward +X (main.cpp:105-115);
- x_model = R_world_model^T (x_world - p_world_model), implemented as a
  rotation by -yaw (main.cpp:347-349);
- sun_dir_model = normalize(light_in_model) — the model->Sun direction
  (main.cpp:356); NOTE the renderer then negates it (parity quirk).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from dsrt_tpu_torch.utils.pose import Pose


def rotate_yaw_deg(v: np.ndarray, yaw_deg: float) -> np.ndarray:
    """R_y(yaw) v in float64: (c x + s z, y, -s x + c z)."""
    rad = math.radians(yaw_deg)
    c, s = math.cos(rad), math.sin(rad)
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]],
                    np.float64)


@dataclasses.dataclass
class FrameSetup:
    """Everything the renderer needs for one frame, in model-frame f32."""
    cam_in_model: np.ndarray   # f32[3]
    sun_dir_model: np.ndarray  # f32[3] (model->Sun; renderer negates)
    separation_m: float


def pose_to_frame(pose: Pose, min_separation_m: float = 1.0
                  ) -> Optional[FrameSetup]:
    """World->model transform for one pose (src/main.cpp:331-357).

    Returns None when the camera is within `min_separation_m` of the model
    (the reference skips such frames, main.cpp:340-344).
    """
    yaw = float(pose.euler_deg[0])
    cam_rel = pose.cam_pos_world - pose.model_pos_world
    light_rel = np.zeros(3) - pose.model_pos_world

    sep = float(np.linalg.norm(cam_rel))
    if sep < min_separation_m:
        return None

    cam_in_model = rotate_yaw_deg(cam_rel, -yaw)
    light_in_model = rotate_yaw_deg(light_rel, -yaw)

    ln = np.linalg.norm(light_in_model)
    sun_dir = light_in_model / ln if ln > 0 else np.zeros(3)

    return FrameSetup(cam_in_model=cam_in_model.astype(np.float32),
                      sun_dir_model=sun_dir.astype(np.float32),
                      separation_m=sep)


def two_float_split(x: np.ndarray):
    """Dekker-style split of f64 values into (hi, lo) float32 pairs with
    x ≈ hi + lo — the extended-precision representation to use if frame
    transforms ever move on-device (BASELINE.json north_star).  Provided as
    a library utility; the current pipeline keeps f64 on the host."""
    hi = np.asarray(x, np.float64).astype(np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def two_float_add(a_hi, a_lo, b_hi, b_lo):
    """Knuth two-sum on float32 pairs (device-compatible algebra)."""
    s = a_hi + b_hi
    bb = s - a_hi
    err = (a_hi - (s - bb)) + (b_hi - bb)
    lo = err + a_lo + b_lo
    hi = s + lo
    return hi, lo - (hi - s)
