"""Pose file parse/format.

A copy of dsrt_tpu/utils/pose.py: the port imports nothing of the JAX package.

Format (src/main.cpp:130-173): one pose per non-comment line,
`cam_x cam_y cam_z  model_x model_y model_z  yaw pitch roll`, positions in
meters (float64) in the WORLD frame whose origin is the Sun/light; angles
in degrees.  `#` comments and malformed lines are skipped; a file yielding
zero poses is a failure (caller falls back to the default pose).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Pose:
    cam_pos_world: np.ndarray    # f64[3] meters
    model_pos_world: np.ndarray  # f64[3] meters
    euler_deg: np.ndarray        # f64[3] yaw, pitch, roll (only yaw used)


def parse_pose_lines(lines) -> List[Pose]:
    poses: List[Pose] = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 9:
            continue
        try:
            vals = [float(p) for p in parts[:9]]
        except ValueError:
            continue
        poses.append(Pose(
            cam_pos_world=np.array(vals[0:3], np.float64),
            model_pos_world=np.array(vals[3:6], np.float64),
            euler_deg=np.array(vals[6:9], np.float64)))
    return poses


def read_pose_file(path: str) -> List[Pose]:
    with open(path, "r") as fh:
        return parse_pose_lines(fh)


def default_pose() -> Pose:
    """The built-in fallback pose (src/main.cpp:275-287)."""
    return Pose(cam_pos_world=np.array([0.0, 50.0, 200.0]),
                model_pos_world=np.array([0.0, -100.0, 0.0]),
                euler_deg=np.zeros(3))


def format_pose_line(cam_m: Sequence[float], model_m: Sequence[float],
                     yaw: float = 90.0, pitch: float = 0.0,
                     roll: float = 0.0) -> str:
    """One pose line in the orbit sim's export format
    (lunar_polar_orbit_sim.py:226-230)."""
    return (f"{cam_m[0]: .6f}  {cam_m[1]: .6f}  {cam_m[2]: .6f}    "
            f"{model_m[0]: .6f}  {model_m[1]: .6f}  {model_m[2]: .6f}    "
            f"{yaw: .1f}  {pitch: .1f}  {roll: .1f}\n")


def write_pose_file(path: str, cams_m: np.ndarray, models_m: np.ndarray,
                    yaw: float = 90.0) -> int:
    header = ("# cam_x  cam_y  cam_z     model_x model_y model_z     "
              "yaw  pitch  roll\n")
    n = 0
    with open(path, "w") as fh:
        fh.write(header)
        for cam, mdl in zip(cams_m, models_m):
            fh.write(format_pose_line(cam, mdl, yaw))
            n += 1
    return n
