"""The split pipeline (dsrt_tpu_torch/ops/wavefront.py and the render
entry points over it) against the JAX reference (dsrt_tpu/ops/wavefront.py,
dsrt_tpu/render.py), with the JAX side on its per-lane walk.

Each side builds its own scene, camera and RenderConfig from the same
numbers.  The wave loops are compared by their accumulators and exact ray
counts: op by op (jit disabled) they are equal; jitted, XLA-CPU contracts
a*b+c into fused multiply-adds, which the port does not, so the
accumulators agree within 1e-6 (sums of clamped radiance in [0, spp]) and
the ray counts exactly.  On the sphere scenes with a sphere light, the
lens or a medium, the port takes cos, sin and log in float64 rounded once
and XLA-CPU in its float32 lowerings, an ulp apart (tests/
test_torch_sphere_ops.py); a light sample's pdf at grazing angles
magnifies that, so there the ray counts are equal (no path branches
differently), 90% of the accumulator entries agree within 1e-6 and all
within 1e-2 (measured: 94.4% and 5.1e-3 at worst).  Frames are compared by u8 share: at least 99% of
pixels identical and mean |d| <= 0.5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrt_tpu.ops.trace as jtrace
from dsrt_tpu.config import RenderConfig as JRenderConfig
from dsrt_tpu.exec_opts import OPTS as JOPTS
from dsrt_tpu.models.mesh_gen import iss_mixed_scene as jmixed
from dsrt_tpu.models.presets import random_tri_soup_scene as jsoup
from dsrt_tpu.models.presets import volumetric_scene as jvolumetric
from dsrt_tpu.ops import wavefront as jwf
from dsrt_tpu.ops.camera import make_camera as jmake_camera
from dsrt_tpu.ops.camera import point_camera_at as jpoint
from dsrt_tpu.render import lane_layout as jlane_layout
from dsrt_tpu.render import render_frame_queue as jrender_queue
from dsrt_tpu.render import render_frame_wavefront as jrender_wavefront
from dsrt_tpu_torch import driver, render
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.exec_opts import OPTS
from dsrt_tpu_torch.models.mesh_gen import iss_mixed_scene
from dsrt_tpu_torch.models.presets import (dof_motion_scene,
                                           random_tri_soup_scene,
                                           single_triangle_scene,
                                           volumetric_scene)
from dsrt_tpu_torch.ops import wavefront
from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
from dsrt_tpu_torch.ops.path_kernel import path_render_plain
from dsrt_tpu_torch.ops.shade import bounce_step
from dsrt_tpu_torch.render import (lane_layout, render_frame_queue,
                                   render_frame_wavefront)
from dsrt_tpu_torch.utils.image_io import read_png
from test_torch_render import assert_images_match

W, H = 32, 24
CFG = dict(width=W, height=H, spp=4, max_depth=8)
B = 2
SUNLIT = (-20.0, -30.0, -95.0)


def _soup():
    kw = dict(vfov=50, width=W, height=H)
    return (random_tri_soup_scene(n=300, device="cpu"),
            make_camera((0, 0, 1.0), (0, 0, -3), **kw, device="cpu"),
            jsoup(n=300), jmake_camera((0, 0, 1.0), (0, 0, -3), **kw))


def _mixed():
    kw = dict(vfov=40, width=W, height=H)
    return (iss_mixed_scene(detail=2, device="cpu"),
            point_camera_at(SUNLIT, **kw, device="cpu"),
            jmixed(detail=2), jpoint(SUNLIT, **kw))


def _dof_motion():
    """A moving sphere, the lens and the shutter: the regeneration's
    aperture and shutter-time draws."""
    from test_fused_spheres import _dof_motion_scene
    kw = dict(vfov=60, width=W, height=H, aperture=0.2)
    look = ((0.0, 0.4, 1.2), (0.0, 0.0, -1.0))
    return (dof_motion_scene(sun=True, device="cpu"),
            make_camera(*look, **kw, device="cpu"),
            _dof_motion_scene(sun=True), jmake_camera(*look, **kw))


def _volumetric():
    """A constant medium: one draw per medium on every query."""
    kw = dict(vfov=50, width=W, height=H)
    look = ((0.0, 0.6, 2.0), (0.0, 0.0, -1.0))
    return (volumetric_scene(device="cpu"),
            make_camera(*look, **kw, device="cpu"), jvolumetric(),
            jmake_camera(*look, **kw))


SCENES = {"soup": _soup, "mixed": _mixed, "dof_motion": _dof_motion,
          "volumetric": _volumetric}
# each scene's RenderConfig on top of CFG
EXTRA = {"dof_motion": dict(aperture=0.2, time0=0.2, time1=0.8)}
# scenes whose shading takes transcendentals (the tolerance above)
ULP_SCENES = ("dof_motion", "volumetric")
_cache = {}


def _cfgs(name):
    """(port RenderConfig, JAX RenderConfig) of a scene, built apart."""
    kw = dict(CFG, **EXTRA.get(name, {}))
    return RenderConfig(**kw), JRenderConfig(**kw)


def _scenes(name):
    if name not in _cache:
        _cache[name] = SCENES[name]()
    return _cache[name]


@pytest.fixture
def lane_forced(monkeypatch):
    """The reference on its per-lane walk (the port's walk), Pallas off."""
    monkeypatch.setattr(jtrace, "LANE_SWITCH_TRIS", 0)
    monkeypatch.setattr(JOPTS, "pallas", "off")


def _slot_lanes(width, height, batch):
    px, py, valid, _ = lane_layout(width, height)
    lanes = [np.tile(a, (batch, 1)) for a in (px, py, valid)]
    lanes.append(np.repeat(np.arange(batch), px.shape[0])[:, None]
                 .repeat(1024, axis=1))
    return lanes


def _jax_lanes(lanes):
    px, py, valid, slot = lanes
    return dict(px=jnp.asarray(px.astype(np.int32)),
                py=jnp.asarray(py.astype(np.int32)),
                valid=jnp.asarray(valid),
                slot=jnp.asarray(slot.astype(np.uint32)))


def _assert_accum_close(got, want, tol, lit=0.05, ulp_scene=False):
    got = np.stack([np.asarray(c) for c in got], -1)
    want = np.stack([np.asarray(c) for c in want], -1)
    assert got.shape == want.shape
    d = np.abs(got - want)
    if ulp_scene:
        assert (d <= tol).mean() >= 0.9 and d.max() <= 1e-2
    else:
        assert d.max() <= tol
    assert (want > 0).mean() > lit


def test_lane_layout_matches_jax():
    for w, h in ((W, H), (64, 36), (800, 450)):
        got, want = lane_layout(w, h), jlane_layout(w, h)
        for g, x in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, x)
        assert got[3] == want[3]
    px, py, _, (ty, tx) = lane_layout(64, 36)
    img = render.lanes_to_image(torch.as_tensor(py * 1000 + px), ty, tx)
    yy, xx = np.mgrid[0:64, 0:64]
    np.testing.assert_array_equal(img.numpy(), yy * 1000 + xx)


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_accumulate_matches_jax(lane_forced, name):
    ts, tc, js, jc = _scenes(name)
    cfg, jcfg = _cfgs(name)
    lanes = _slot_lanes(W, H, B)
    acc, n = wavefront.trace_accumulate(
        ts, cfg, tc, *map(torch.as_tensor, lanes), CFG["spp"] // B)
    run = jax.jit(functools.partial(
        jwf.trace_accumulate, cfg=jcfg, spp_local=CFG["spp"] // B,
        count_rays=True))
    jacc, jn = run(js, cam=jc, **_jax_lanes(lanes))
    _assert_accum_close(acc, jacc, 1e-6, ulp_scene=name in ULP_SCENES)
    assert int(n) == int(jn) > W * H * CFG["spp"]


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_queue_matches_jax(lane_forced, name):
    ts, tc, js, jc = _scenes(name)
    cfg, jcfg = _cfgs(name)
    acc, n = wavefront.trace_queue(ts, cfg, tc, W, H, (2, 1024))
    run = jax.jit(functools.partial(
        jwf.trace_queue, cfg=jcfg, width=W, height=H, pool_shape=(2, 1024),
        count_rays=True))
    jacc, jn = run(js, cam=jc)
    _assert_accum_close(acc.T, np.asarray(jacc).T, 1e-6,
                        ulp_scene=name in ULP_SCENES)
    assert int(n) == int(jn) > W * H * CFG["spp"]


def test_wave_loops_match_jax_op_by_op(lane_forced):
    """Small enough to run the JAX loops without jit: equal accumulators
    and ray counts."""
    ts, tc, js, jc = _scenes("soup")
    cfg = dict(width=16, height=8, spp=2, max_depth=4)
    lanes = _slot_lanes(16, 8, 2)
    acc, n = wavefront.trace_accumulate(
        ts, RenderConfig(**cfg), tc, *map(torch.as_tensor, lanes), 1)
    q, qn = wavefront.trace_queue(ts, RenderConfig(**cfg), tc, 16, 8,
                                  (1, 1024))
    with jax.disable_jit():
        jacc, jn = jwf.trace_accumulate(js, JRenderConfig(**cfg), jc,
                                        spp_local=1, count_rays=True,
                                        **_jax_lanes(lanes))
        jq, jqn = jwf.trace_queue(js, JRenderConfig(**cfg), jc, 16, 8,
                                  (1, 1024), count_rays=True)
    # 128 of the 2048 lanes hold pixels of the 16x8 frame
    _assert_accum_close(acc, jacc, 0.0, lit=0.002)
    _assert_accum_close(q.T, np.asarray(jq).T, 0.0, lit=0.02)
    assert int(n) == int(jn) and int(qn) == int(jqn)


@pytest.mark.parametrize("name", ["soup", "mixed"])
def test_render_frame_wavefront_matches_jax(lane_forced, name):
    ts, tc, js, jc = _scenes(name)
    got, n = render_frame_wavefront(ts, tc, RenderConfig(**CFG),
                                    spp_batch=B, with_count=True)
    want, jn = jrender_wavefront(js, jc, JRenderConfig(**CFG), spp_batch=B,
                                 with_count=True)
    assert_images_match(got, np.asarray(want))
    assert n == jn
    assert (got > 0).mean() > 0.05


def test_render_frame_queue_matches_jax(lane_forced):
    ts, tc, js, jc = _scenes("mixed")
    got = render_frame_queue(ts, tc, RenderConfig(**CFG))
    want = jrender_queue(js, jc, JRenderConfig(**CFG))
    assert_images_match(got, np.asarray(want))
    assert (got > 0).mean() > 0.05


def test_queue_banding_matches_the_unbanded_frame(monkeypatch):
    ts, tc, _, _ = _scenes("soup")
    cfg = RenderConfig(**CFG)
    whole = render_frame_queue(ts, tc, cfg)
    # ids of a 32x6 band at 4 spp plus the 1024-lane pool: 1792
    monkeypatch.setattr(render, "QUEUE_ID_LIMIT", 2000)
    calls = []
    real = render.trace_queue
    monkeypatch.setattr(render, "trace_queue",
                        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw))
    banded = render_frame_queue(ts, tc, cfg)
    assert calls == [6, 6, 6, 6]
    np.testing.assert_array_equal(banded, whole)


def test_spp_batch_must_divide_spp():
    ts, tc, _, _ = _scenes("soup")
    with pytest.raises(ValueError, match="spp_batch"):
        render_frame_wavefront(ts, tc, RenderConfig(**CFG), spp_batch=3)


def test_fused_sun_changes_neither_rays_nor_pixels(monkeypatch):
    """One traverse_with_sun query per wave instead of two walks: the
    shadow origin uses the kernel's geometric normal instead of the
    stored face normal, so pixels may differ in the last bits only; the
    plain versions of the megakernels never fuse."""
    ts, tc, _, _ = _scenes("soup")
    cfg = RenderConfig(**CFG)
    off, n_off = render_frame_wavefront(ts, tc, cfg, spp_batch=B,
                                        with_count=True)
    plain_off = path_render_plain(ts, tc, cfg, cfg.spp)
    monkeypatch.setattr(OPTS, "fused_sun", True)
    on, n_on = render_frame_wavefront(ts, tc, cfg, spp_batch=B,
                                      with_count=True)
    plain_on = path_render_plain(ts, tc, cfg, cfg.spp)
    assert_images_match(on, off)
    assert n_on == n_off
    assert torch.equal(plain_on[0], plain_off[0])


def test_bounce_step_takes_a_known_walk():
    ts, _, _, _ = _scenes("soup")
    z = torch.zeros(4)
    v = (z, z, z)
    with pytest.raises(ValueError, match="walk"):
        bounce_step(ts, RenderConfig(**CFG), v, v, v, v,
                    torch.zeros(4, dtype=torch.int64),
                    torch.ones(4, dtype=torch.bool),
                    torch.zeros(4, dtype=torch.bool), v, torch.zeros(4),
                    walk="packet")


def test_driver_modes(tmp_path, capsys):
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.scene import SceneBuilder
    ts, _, _, _ = _scenes("mixed")
    tri = single_triangle_scene(device="cpu")
    cfg = RenderConfig(**CFG)
    # the mixed stand-in goes to the path kernel; a triangle scene with
    # more spheres than the path kernel takes, to the wavefront
    assert driver.resolve_mode("auto", ts, cfg) == "fused"
    b = SceneBuilder(seed=1337)
    b.add_triangle((-1.0, -1.0, -2.0), (1.0, -1.0, -2.0), (0.0, 1.0, -2.0),
                   Material.lambertian())
    for i in range(13):
        b.add_sphere((0.1 * i, 0.0, -1.0), 0.05, Material.lambertian())
    many = b.build(device="cpu")
    assert driver.resolve_mode("auto", many, cfg) == "wavefront"
    assert driver.resolve_mode("fused", many, cfg) == "wavefront"
    assert "falling back" in capsys.readouterr().out
    assert driver.resolve_mode("auto", tri, cfg) == "fused"
    for mode in ("parity", "wavefront", "queue"):
        assert driver.resolve_mode(mode, tri, cfg) == mode
    with pytest.raises(SystemExit):
        driver.build_parser().parse_args(["--mode", "packet"])
    for mode in ("wavefront", "queue", "parity", "auto"):
        out = tmp_path / mode
        rc = driver.main(["--output_dir", str(out), "--width", "24",
                          "--height", "16", "--spp", "4", "--spp_batch", "8",
                          "--max_depth", "4", "--standin_detail", "1",
                          "--mode", mode, "--device", "cpu"])
        assert rc == 0
        assert read_png(str(out / "frame_0000.png")).shape == (16, 24, 3)
    log = capsys.readouterr().out
    for mode in ("wavefront", "queue", "parity", "fused"):
        assert f"render ({mode} on cpu)" in log
