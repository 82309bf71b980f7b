"""The slice as a whole: dsrt_tpu_torch.render.render_frame (the plain
version of the path kernel) against dsrt_tpu.render.render_frame, the JAX
parity renderer, with the reference forced onto its per-ray walk.

Expected u8-exact.  The tolerance — at least 99% of pixels identical and
mean |d| <= 0.5 u8 — covers two sources of last-bit differences that can
move a path: XLA-CPU's cos/sin/pow lowerings (the port evaluates them in
float64 and rounds once) and its contraction of a*b+c into fused
multiply-adds, which the port does not perform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.config import RenderConfig
from dsrt_tpu.exec_opts import OPTS
from dsrt_tpu.models.mesh_gen import iss_standin_scene as jscene
from dsrt_tpu.models.scene import SceneBuilder as JSceneBuilder
from dsrt_tpu.ops import rng as jrng
from dsrt_tpu.ops.camera import camera_rays
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.ops.camera import point_camera_at as jpoint
from dsrt_tpu.ops.shade import trace_paths as jtrace_paths
from dsrt_tpu.render import lane_layout
from dsrt_tpu.render import render_frame as jrender
from dsrt_tpu_torch.models.mesh_gen import write_panel_texture
from dsrt_tpu_torch.models.scene import scene_from_reference
from dsrt_tpu_torch.ops.camera import camera_from_reference
from dsrt_tpu_torch.render import render_frame, render_frame_fused
from test_torch_scene import mixed_material_scene

CFG = RenderConfig(width=48, height=32, spp=2, max_depth=6)
SUNLIT = (-20.0, -30.0, -95.0)


@pytest.fixture
def lane_forced(monkeypatch):
    """The reference on its per-ray walk (the port's walk), Pallas off."""
    monkeypatch.setattr(jtrace, "LANE_SWITCH_TRIS", 0)
    monkeypatch.setattr(OPTS, "pallas", "off")


def assert_images_match(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    same = (diff.max(axis=-1) == 0).mean()
    assert same >= 0.99, f"{same:.4f} of pixels identical"
    assert diff.mean() <= 0.5, f"mean |d| {diff.mean():.4f}"


def reference_ray_count(js, jc, cfg):
    """Exact ray count of the reference's sample loop (render.py
    _render_lanes with trace_paths(count_rays=True)), lens and shutter
    draws included."""
    px, py, valid, _ = lane_layout(cfg.width, cfg.height)
    spp = cfg.resolved_spp()

    @jax.jit
    def run(scene, cam, px, py, valid):
        state = jrng.seed_pixels(px, py, cam.width, scene.seed)
        total = jnp.int32(0)
        for s in range(spp):
            jxu, state = jrng.draw(state, valid)
            jyu, state = jrng.draw(state, valid)
            jx = (jnp.float32(s) + jxu) / jnp.float32(spp)
            jy = (jnp.float32(s) + jyu) / jnp.float32(spp)
            ro, rd, state = camera_rays(cam, px, py, jx, jy, state, valid,
                                        cfg.aperture > 0)
            time = None
            if cfg.time1 > cfg.time0:
                ut, state = jrng.draw(state, valid)
                time = cfg.time0 + ut * (cfg.time1 - cfg.time0)
            _, state, n = jtrace_paths(scene, cfg, ro, rd, state, valid,
                                       count_rays=True, time=time)
            total = total + n
        return total

    return int(run(js, jc, jnp.asarray(px), jnp.asarray(py),
                   jnp.asarray(valid)))


def test_textured_standin_matches_reference(lane_forced, tmp_path):
    tex = str(tmp_path / "panel.png")
    write_panel_texture(tex)
    js = jscene(detail=3, tex_path=tex)
    assert js.has_image_tex and js.n_tris > jtrace.LANE_SWITCH_TRIS
    jc = jpoint(SUNLIT, vfov=CFG.vfov, width=CFG.width, height=CFG.height)
    want = jrender(js, jc, CFG)
    got, nrays = render_frame(scene_from_reference(js, device="cpu"),
                              camera_from_reference(jc, device="cpu"), CFG,
                              with_count=True)
    assert (got > 0).mean() > 0.3, "sunlit frame expected"
    assert_images_match(got, want)
    # every closest-hit query and every potential sun receiver, counted
    # exactly on both sides
    assert nrays == reference_ray_count(js, jc, CFG)


def test_mixed_materials_match_reference(lane_forced):
    js = mixed_material_scene(JSceneBuilder)
    jc = jmake_camera((0.0, 0.8, 2.5), (0.0, 0.0, -3.0), vfov=55.0,
                      width=CFG.width, height=CFG.height)
    want = jrender(js, jc, CFG)
    got = render_frame(scene_from_reference(js, device="cpu"),
                       camera_from_reference(jc, device="cpu"), CFG)
    assert (got > 0).mean() > 0.3
    assert_images_match(got, want)


def test_fused_entry_on_cpu_is_the_plain_renderer():
    js = mixed_material_scene(JSceneBuilder, n=30)
    jc = jmake_camera((0.0, 0.8, 2.5), (0.0, 0.0, -3.0), vfov=55.0,
                      width=24, height=16)
    cfg = RenderConfig(width=24, height=16, spp=3, max_depth=5)
    s = scene_from_reference(js, device="cpu")
    c = camera_from_reference(jc, device="cpu")
    np.testing.assert_array_equal(render_frame_fused(s, c, cfg),
                                  render_frame(s, c, cfg))


def test_over_budget_frames_render_in_salted_chunks():
    """Above the per-launch budget the frame renders as spp chunks whose
    LCG streams are salted; chunk 0 keeps the unsalted stream."""
    from dsrt_tpu_torch.ops import path_kernel
    from dsrt_tpu_torch.render import fused_chunk_spp, render_accum_fused
    js = mixed_material_scene(JSceneBuilder, n=30)
    jc = jmake_camera((0.0, 0.8, 2.5), (0.0, 0.0, -3.0), vfov=55.0,
                      width=16, height=12)
    cfg = RenderConfig(width=16, height=12, spp=5, max_depth=4)
    s = scene_from_reference(js, device="cpu")
    c = camera_from_reference(jc, device="cpu")
    budget = 16 * 12 * 2
    assert fused_chunk_spp(cfg, budget) == 2
    acc, n = render_accum_fused(s, c, cfg, budget)
    parts = [path_kernel.path_render_plain(s, c, cfg, k, salt)
             for k, salt in ((2, 0), (2, 0x9E3779B9),
                             (1, (2 * 0x9E3779B9) & 0xFFFFFFFF))]
    want = parts[0][0] + parts[1][0] + parts[2][0]
    assert np.array_equal(acc.numpy(), want.numpy())
    assert int(n) == sum(int(p[1]) for p in parts)


@pytest.mark.slow
def test_matches_fused_pallas_kernel_in_interpret_mode():
    """Against the reference megakernel itself (pallas_path._path_kernel,
    interpreted on the CPU): 32x16, spp 1, depth 3."""
    from jax.experimental.pallas import tpu as pltpu
    from dsrt_tpu.render import render_frame_fused as jfused
    cfg = RenderConfig(width=32, height=16, spp=1, max_depth=3)
    js = jscene(detail=1)
    jc = jpoint((20.0, 30.0, 95.0), vfov=cfg.vfov, width=32, height=16)
    with pltpu.force_tpu_interpret_mode():
        want = jfused(js, jc, cfg)
    got = render_frame(scene_from_reference(js, device="cpu"),
                       camera_from_reference(jc, device="cpu"), cfg)
    assert_images_match(got, want)
