"""The CUDA kernels of dsrt_tpu_torch against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from dsrt_tpu.config import RenderConfig
from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                            write_panel_texture)
from dsrt_tpu_torch.models import presets
from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.trace import lane_traverse
from dsrt_tpu_torch.render import render_frame, render_frame_fused, tonemap

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def scene_cpu(tmp_path):
    tex = str(tmp_path / "panel.png")
    write_panel_texture(tex)
    return iss_standin_scene(detail=3, tex_path=tex)


def _rays(n, device, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=40.0, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[:, : n // 2] = -o[:, : n // 2]
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (V3(*(torch.from_numpy(c).to(device) for c in o)),
            V3(*(torch.from_numpy(c).to(device) for c in d)))


def test_closest_hit_kernel_matches_plain_walk(cuda, scene_cpu):
    scene = scene_cpu.to(cuda)
    ro, rd = _rays(1 << 16, cuda)
    before = path_kernel.LAUNCHES["dsrt_closest_hit"]
    got = path_kernel.closest_hit(scene, ro, rd)
    torch.cuda.synchronize()
    assert path_kernel.LAUNCHES["dsrt_closest_hit"] == before + 1
    want = lane_traverse(scene, ro, rd, 1e-3, 1e9,
                         torch.ones(1 << 16, dtype=torch.bool, device=cuda))
    assert (want[3] >= 0).sum() > 1000
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_path_kernel_matches_plain_renderer(cuda, scene_cpu):
    """Tolerance for cos/sin/pow, which both sides evaluate in double and
    round once: they can differ only when a double result lies within an
    ulp of a float rounding boundary."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6)
    cam = point_camera_at((-20.0, -30.0, -95.0), vfov=cfg.vfov, width=48,
                          height=32)
    before = path_kernel.LAUNCHES["dsrt_path_render"]
    acc, n = path_kernel.path_render(scene_cpu.to(cuda), cam.to(cuda), cfg)
    torch.cuda.synchronize()
    assert path_kernel.LAUNCHES["dsrt_path_render"] == before + 1
    got = tonemap(acc, cfg, cfg.spp)
    want, n_plain = render_frame(scene_cpu, cam, cfg, with_count=True)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff.max(axis=-1) == 0).mean() >= 0.98
    assert diff.mean() <= 1.0
    assert abs(int(n) - n_plain) <= 0.01 * n_plain
    assert (got > 0).mean() > 0.3


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, scene_cpu):
    scene = scene_cpu.to(cuda)
    ro, rd = _rays(64, cuda)
    with pytest.raises(ValueError):
        path_kernel.closest_hit(scene, V3(*(c.double() for c in ro)), rd)
    with pytest.raises(ValueError):
        path_kernel.closest_hit(scene_cpu, ro, rd)


SPHERE_CASES = {
    "rtiow_smoke_scene": (lambda: presets.rtiow_smoke_scene(), {},
                          (0.0, 0.6, 2.0), 50),
    "sphere_light_scene": (lambda: presets.sphere_light_scene(), {},
                           (0.0, 0.6, 2.0), 50),
    "volumetric_scene": (lambda: presets.volumetric_scene(), {},
                         (0.0, 0.6, 2.0), 50),
    "dof_motion": (lambda: presets.dof_motion_scene(sun=True),
                   dict(aperture=0.2, time0=0.2, time1=0.8),
                   (0.0, 0.4, 1.2), 60),
    "env": (lambda: presets.env_sphere_scene(
        np.random.default_rng(5).uniform(0.0, 2.0, (8, 16, 3)).astype(
            np.float32), rotation_deg=30.0, scale=1.5), {},
            (0.0, 0.6, 2.0), 50),
}


@pytest.mark.parametrize("name", list(SPHERE_CASES))
def test_sphere_kernel_matches_plain_version(cuda, name):
    """Identical accumulators and ray count: both sides take cos, sin and
    log in double and round once, and the kernel is built without
    contraction."""
    make, extra, look, vfov = SPHERE_CASES[name]
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=12, **extra)
    cam = make_camera(look, (0.0, 0.0, -1.0), vfov=vfov, width=64,
                      height=36, aperture=extra.get("aperture", 0.0))
    scene_cpu = make()
    before = sphere_kernel.LAUNCHES["dsrt_sphere_render"]
    acc, n = sphere_kernel.sphere_render(scene_cpu.to(cuda), cam.to(cuda),
                                         cfg)
    torch.cuda.synchronize()
    assert sphere_kernel.LAUNCHES["dsrt_sphere_render"] == before + 1
    want, n_plain = sphere_kernel.sphere_render_plain(scene_cpu, cam, cfg,
                                                      cfg.spp)
    assert torch.equal(acc.cpu(), want)
    assert int(n) == int(n_plain)
    assert (want > 0).float().mean() > 0.05


def test_sphere_frames_go_through_the_sphere_kernel(cuda):
    scene = presets.volumetric_scene(device=cuda)
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=8)
    cam = make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=50, width=64,
                      height=36, device=cuda)
    sphere_kernel.reset_launches()
    img, n = render_frame_fused(scene, cam, cfg, with_count=True)
    assert sphere_kernel.LAUNCHES["dsrt_sphere_render"] == 1
    assert img.shape == (36, 64, 3) and n >= 64 * 36 * 2
    bad = dataclasses.replace(scene, mat_pack=scene.mat_pack.double())
    with pytest.raises(ValueError):
        sphere_kernel.sphere_render(bad, cam, cfg)
