"""The CUDA kernels of dsrt_tpu_torch against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from dsrt_tpu.config import RenderConfig
from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                            write_panel_texture)
from dsrt_tpu_torch.ops import path_kernel
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.trace import lane_traverse
from dsrt_tpu_torch.render import render_frame, tonemap

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
