"""A frame's camera and sun as the driver makes them, against the
construction they replaced, bit for bit, on the CPU.

`make_camera` sends its 22 floats in one copy (on the card from pinned
memory) and the fields and the kernels' camera vector are views of that
tensor (`Camera.flat`); the scene keeps host copies of its sun
(`Scene.sun_dir_host`, `sun_radiance_host`), from which the path
kernel's wrapper builds its sun vector with no read from the device
(`sun_vector`).  For the rendezvous poses 0, 49 and 93-98
(portbench/data/poses99.txt) each must give the bits of the old
construction, rebuilt here from the same NumPy values: one tensor a
camera field, from the JAX package's float32 set-up, their
concatenation the camera vector, and the sun vector from a read of the
scene's sun tensors.  `frame_inputs` on the CPU gives that camera and
the pose's sun.  The card's side (the same bits,
and no host-device synchronisation in the issue path) is in
tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from dsrt_tpu.ops.camera import point_camera_at as jax_point_camera_at
from dsrt_tpu_torch import driver
from dsrt_tpu_torch.device import to_device
from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
from dsrt_tpu_torch.ops import path_kernel
from dsrt_tpu_torch.ops.camera import (FIELDS, Camera, camera_from_reference,
                                       point_camera_at)
from dsrt_tpu_torch.ops.linalg import V3, normalize
from dsrt_tpu_torch.utils.pose import read_pose_file
from dsrt_tpu_torch.utils.transform import pose_to_frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSES = os.path.join(ROOT, "portbench", "data", "poses99.txt")
PICKS = (0, 49, 93, 94, 95, 96, 97, 98)
# Run A's frame and the driver's field of view
ARGS = ["--device", "cpu", "--width", "800", "--height", "450", "--vfov",
        "40", "--spp", "250"]
BIAS = 1e-3


@pytest.fixture(scope="module")
def frames():
    return {i: pose_to_frame(p) for i, p in enumerate(read_pose_file(POSES))
            if i in PICKS}


@pytest.fixture(scope="module")
def scene():
    return iss_standin_scene(detail=1, device="cpu")


def _bits(t: torch.Tensor) -> list:
    return t.detach().contiguous().view(torch.int32).reshape(-1).tolist()


def _old_camera(frame, width=800, height=450, vfov=40.0) -> dict:
    """The camera as make_camera built it before: one tensor a field,
    from the reference's float32 NumPy values, and the camera vector as
    Camera.vector concatenated them."""
    ref = jax_point_camera_at(frame.cam_in_model, (0.0, 0.0, 0.0),
                              vfov=vfov, width=width, height=height)
    old = {f: torch.as_tensor(np.array(getattr(ref, f), np.float32))
           for f in FIELDS}
    old["vector"] = torch.cat([old[f].reshape(-1) for f in FIELDS[:7]])
    old["size"] = (width, height)
    return old


def _old_sun_vector(scene, bias: float) -> torch.Tensor:
    """path_kernel.sun_vector as it was: Ldir from a read of the scene's
    sun_dir tensor, the radiance read element by element."""
    sd = scene.sun_dir.detach().to("cpu", torch.float32)
    ldir = normalize(V3(-sd[0], -sd[1], -sd[2]))
    return torch.tensor([float(c) for c in ldir]
                        + [float(c) for c in scene.sun_radiance]
                        + [float(bias)], dtype=torch.float32)


def _same_camera(cam: Camera, old: dict) -> None:
    for f in FIELDS:
        x, y = getattr(cam, f), old[f]
        assert x.shape == y.shape and x.dtype == y.dtype == torch.float32, f
        assert _bits(x) == _bits(y), f
    assert (cam.width, cam.height) == old["size"]
    assert cam.vector().shape == (19,)
    assert _bits(cam.vector()) == _bits(old["vector"])


@pytest.mark.parametrize("pose", PICKS)
def test_camera_views_of_one_tensor_equal_the_old_camera(frames, pose):
    """The fields and the camera vector are views of the 22 floats, with
    the old camera's bits, from make_camera and camera_from_reference."""
    old = _old_camera(frames[pose])
    cam = point_camera_at(frames[pose].cam_in_model, vfov=40.0, width=800,
                          height=450, device="cpu")
    _same_camera(cam, old)
    base = cam.flat.untyped_storage().data_ptr()
    assert all(getattr(cam, f).untyped_storage().data_ptr() == base
               for f in FIELDS)
    assert cam.vector().data_ptr() == cam.flat.data_ptr()
    ref = jax_point_camera_at(frames[pose].cam_in_model, (0.0, 0.0, 0.0),
                              vfov=40.0, width=800, height=450)
    _same_camera(camera_from_reference(ref, device="cpu"), old)
    _same_camera(cam.to("cpu"), old)


@pytest.mark.parametrize("pose", PICKS)
def test_sun_vector_from_the_host_copy_equals_the_old_one(scene, frames,
                                                          pose):
    s = scene.with_sun(frames[pose].sun_dir_model)
    assert _bits(torch.from_numpy(s.sun_dir_host)) == _bits(s.sun_dir)
    want = _old_sun_vector(s, BIAS)
    assert _bits(path_kernel.sun_vector(s, BIAS)) == _bits(want)
    # Scene.to carries the host copies along
    moved = s.to("cpu")
    assert moved.sun_dir_host is s.sun_dir_host
    assert _bits(path_kernel.sun_vector(moved, BIAS)) == _bits(want)


@pytest.mark.parametrize("pose", PICKS)
def test_frame_inputs_on_the_cpu_are_unchanged(scene, frames, pose):
    args = driver.build_parser().parse_args(ARGS)
    s, cam = driver.frame_inputs(args, scene, frames[pose],
                                 torch.device("cpu"))
    _same_camera(cam, _old_camera(frames[pose]))
    want = np.asarray(frames[pose].sun_dir_model, np.float32)
    assert _bits(s.sun_dir) == _bits(torch.from_numpy(want))
    assert s.sun_dir.device.type == "cpu"
    assert s.tri_pack is scene.tri_pack and s.cache is scene.cache


def test_a_built_scene_keeps_the_host_copy_of_its_sun(scene):
    assert scene.sun_dir_host.dtype == np.float32
    assert _bits(torch.from_numpy(scene.sun_dir_host)) == _bits(scene.sun_dir)
    assert _bits(torch.from_numpy(scene.sun_radiance_host)) == _bits(
        scene.sun_radiance)


def test_to_device_off_the_card_is_as_tensor():
    a = np.array([1.5, -0.0, 3e-39], np.float32)
    t = to_device(a, "cpu")
    assert t.dtype == torch.float32 and _bits(t) == _bits(torch.from_numpy(a))
