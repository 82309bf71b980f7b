"""Adaptive sampling and the megakernels' pixel-list launch on the CPU.

- dsrt_tpu_torch.render.render_frame_adaptive (its rounds through the
  plain versions of the kernels' list launch) against the JAX package's
  render_frame_adaptive, whose rounds run the TPU megakernels themselves,
  interpreted on the CPU (`pltpu.force_tpu_interpret_mode()`).  JAX's
  `fused_kind` answers None off a TPU, so the test names the kernel for
  it.  Tolerance: u8-exact with equal rays, samples and rounds on rtiow;
  on the triangle case (the path kernel) at least 99% identical pixels
  and mean |d| <= 0.5 u8 (XLA-CPU fuses multiply-adds in the interpreted
  kernel; measured: identical) with equal samples.
- The plain list launch of both kernels against the full-frame plain
  version at the same pixels, salt 0 and not: identical rows and ray
  counts that add up over a set and its complement.
- The round schedule: with a negative tol every pixel runs to the cap,
  and the rounds' sums are the chunks of render_accum_fused at a budget
  of one round (the same spp and salt a launch).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dsrt_tpu.render as jrender
from dsrt_tpu.config import RenderConfig as JRenderConfig
from dsrt_tpu.models import presets as jpresets
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu_torch import render as trender
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models import presets as tpresets
from dsrt_tpu_torch.models.scene import SceneBuilder, scene_from_reference
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
from dsrt_tpu_torch.ops.camera import camera_from_reference, make_camera
from dsrt_tpu_torch.render import (SALT_MIX, render_accum_fused,
                                   render_frame_adaptive)
from test_torch_mixed_frames import FRAME, jax_case
from test_torch_render import assert_images_match

LOOK = ((0.0, 0.6, 2.0), (0.0, 0.0, -1.0))
# cap 8 in rounds of 2: a pixel stops after round 2, 3 or runs to 4
ADAPT = dict(tol=0.05, chunk_spp=2)


def jax_adaptive(monkeypatch, kind, scene, cam, cfg):
    """JAX's adaptive frame and stats, its rounds on the interpreted TPU
    kernel `kind` ('sphere' or 'tri')."""
    monkeypatch.setattr(jrender, "fused_kind", lambda s, c: kind)
    with pltpu.force_tpu_interpret_mode():
        img, stats = jrender.render_frame_adaptive(scene, cam, cfg,
                                                   with_count=True, **ADAPT)
    return np.asarray(img), stats


def test_rtiow_matches_jax_adaptive(monkeypatch):
    cfg = dict(width=32, height=16, spp=8, max_depth=6)
    kw = dict(vfov=50, width=32, height=16)
    want, wstats = jax_adaptive(monkeypatch, "sphere",
                                jpresets.rtiow_smoke_scene(),
                                jmake_camera(*LOOK, **kw),
                                JRenderConfig(**cfg))
    got, stats = render_frame_adaptive(
        tpresets.rtiow_smoke_scene(device="cpu"),
        make_camera(*LOOK, **kw, device="cpu"), RenderConfig(**cfg),
        with_count=True, **ADAPT)
    assert (got > 0).mean() > 0.2
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    # some pixels stopped after round 2, others ran on
    assert 4 < stats["mean_spp"] < 8 and stats["rounds"] == 4


def test_triangle_case_matches_jax_adaptive(monkeypatch):
    js, jc, extra = jax_case("sphere_mix")
    cfg = dict(FRAME, spp=8, **extra)
    want, wstats = jax_adaptive(monkeypatch, "tri", js, jc,
                                JRenderConfig(**cfg))
    scene = scene_from_reference(js, device="cpu")
    assert trender.fused_kind(scene, RenderConfig(**cfg)) == "tri"
    got, stats = render_frame_adaptive(
        scene, camera_from_reference(jc, device="cpu"), RenderConfig(**cfg),
        with_count=True, **ADAPT)
    assert (got > 0).mean() > 0.05
    assert_images_match(got, want)
    assert stats["samples"] == wstats["samples"]
    assert 4 < stats["mean_spp"] < 8


KERNELS = {
    "path": (path_kernel.path_render, path_kernel.path_render_plain,
             lambda: tpresets.mixed_scene(device="cpu")),
    "sphere": (sphere_kernel.sphere_render, sphere_kernel.sphere_render_plain,
               lambda: tpresets.rtiow_smoke_scene(device="cpu")),
}


@pytest.mark.parametrize("salt", [0, 3 * SALT_MIX & 0xFFFFFFFF])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_list_launch_matches_the_frame(kernel, salt):
    wrapper, plain, make_scene = KERNELS[kernel]
    scene = make_scene()
    cfg = RenderConfig(width=24, height=12, spp=3, max_depth=5)
    cam = make_camera(*LOOK, vfov=50, width=24, height=12, device="cpu")
    full, n_full = plain(scene, cam, cfg, 3, salt)
    order = torch.as_tensor(np.random.default_rng(7).permutation(24 * 12))
    subset, rest = order[:90], order[90:]
    got, n_sub = plain(scene, cam, cfg, 3, salt, pixels=subset)
    got_w, n_w = wrapper(scene, cam, cfg, 3, salt, pixels=subset)
    _, n_rest = plain(scene, cam, cfg, 3, salt, pixels=rest)
    assert got.shape == (90, 3) and got.dtype == torch.float32
    assert torch.equal(got, full.reshape(-1, 3)[subset])
    assert torch.equal(got_w, got) and int(n_w) == int(n_sub)
    assert int(n_sub) + int(n_rest) == int(n_full)
    assert (full > 0).float().mean() > 0.2


def test_pixel_lists_are_checked():
    scene = tpresets.rtiow_smoke_scene(device="cpu")
    cfg = RenderConfig(width=8, height=4, spp=1, max_depth=2)
    cam = make_camera(*LOOK, vfov=50, width=8, height=4, device="cpu")
    for bad in (torch.tensor([0, 32]), torch.tensor([-1]),
                torch.tensor([0.0, 1.0]),
                torch.zeros((2, 2), dtype=torch.int64)):
        with pytest.raises(ValueError):
            sphere_kernel.sphere_render(scene, cam, cfg, pixels=bad)
    empty, n = path_kernel.path_render(
        tpresets.mixed_scene(device="cpu"), cam, cfg,
        pixels=torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, 3) and int(n) == 0
    order = path_kernel.tile_order(torch.arange(32).flip(0), 8, 8, 4)
    assert torch.equal(torch.arange(32).flip(0)[order], torch.arange(32))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_rounds_are_the_chunk_schedule(monkeypatch, kernel):
    """A negative tol stops no pixel (tol 0 stops those whose two bucket
    means are equal, as black background pixels are): every pixel runs
    to the cap in rounds of `chunk` samples, and round r's launch (spp
    `chunk`, salt r * 0x9E3779B9) sums what chunk r of render_accum_fused
    at a budget of one round sums."""
    scene = KERNELS[kernel][2]()
    cfg = RenderConfig(width=16, height=8, spp=6, max_depth=4)
    cam = make_camera(*LOOK, vfov=50, width=16, height=8, device="cpu")
    rounds = []
    launch = trender.fused_accum

    def record(*args):
        out = launch(*args)
        rounds.append(out)
        return out

    monkeypatch.setattr(trender, "fused_accum", record)
    _, stats = render_frame_adaptive(scene, cam, cfg, tol=-1.0, chunk_spp=2,
                                     with_count=True)
    assert stats["mean_spp"] == cfg.spp and stats["rounds"] == 3
    want, n_want = render_accum_fused(scene, cam, cfg, budget=16 * 8 * 2)
    got = rounds[0][0] + rounds[1][0] + rounds[2][0]
    assert torch.equal(got, want.reshape(-1, 3))
    assert stats["rays"] == int(n_want)


def test_adaptive_refuses_scenes_no_kernel_covers():
    b = SceneBuilder(seed=1337)
    for i in range(17):
        b.add_sphere((0.1 * i, 0.0, -1.0), 0.05, Material.lambertian())
    scene = b.build(device="cpu")
    cfg = RenderConfig(width=8, height=4, spp=2, max_depth=2)
    assert trender.fused_kind(scene, cfg) is None
    with pytest.raises(ValueError):
        render_frame_adaptive(scene, make_camera(*LOOK, width=8, height=4,
                                                 device="cpu"), cfg)
