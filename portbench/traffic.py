"""The general traffic generator: pose files for the window's calls.

A traffic mix is a JSON file of parameters:

    {"poses": "data/poses99.txt",  the pose file, under the benchmark
     "first": 0, "stop": 99,       the poses [first, stop) of that file
     "stride": 3,                  a call takes every stride-th pose ...
     "repeat": 1}                  ... from offset o, all that `repeat` times

Call k (k = 0, 1, ...) of a run with seed s renders, in order, the poses
first + o, first + o + stride, ... below stop, with o = (s + k) mod
stride, and that list `repeat` times over: every `stride` calls cover the
whole range, and every seed gets the same set of frames in another order.
"""

from __future__ import annotations

from portbench import poses as posemod


def call_poses(mix: dict, seed: int, k: int) -> list:
    """Indices into the pose file of the frames of call k."""
    stride = int(mix.get("stride", 1))
    o = (int(seed) + k) % stride
    one = list(range(int(mix["first"]) + o, int(mix["stop"]), stride))
    return one * int(mix.get("repeat", 1))


def pose_lines(bench, mix: dict) -> list:
    return posemod.read_pose_lines(str(bench.data(mix["poses"])))
