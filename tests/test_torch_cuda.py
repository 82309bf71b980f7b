"""The CUDA kernels of dsrt_tpu_torch against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                            write_panel_texture)
from dsrt_tpu_torch.models import presets
from dsrt_tpu_torch.ops import path_kernel, sphere_kernel, traverse
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
    return iss_standin_scene(detail=3, tex_path=tex, device="cpu")


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
    act = torch.ones(1 << 16, dtype=torch.bool, device=cuda)
    before = traverse.LAUNCHES["dsrt_traverse"]
    got = traverse.traverse(scene, ro, rd, act, 1e-3, 1e9)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["dsrt_traverse"] == before + 1
    want = lane_traverse(scene, ro, rd, 1e-3, 1e9, act)
    assert (want[3] >= 0).sum() > 1000
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_path_kernel_matches_plain_renderer(cuda, scene_cpu):
    """Tolerance for cos/sin/pow, which both sides evaluate in double and
    round once: they can differ only when a double result lies within an
    ulp of a float rounding boundary."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6)
    cam = point_camera_at((-20.0, -30.0, -95.0), vfov=cfg.vfov, width=48,
                          height=32, device="cpu")
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
    act = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        traverse.traverse(scene, V3(*(c.double() for c in ro)), rd, act,
                          1e-3, 1e9)
    with pytest.raises(ValueError):
        traverse.traverse(scene_cpu, ro, rd, act, 1e-3, 1e9)
    with pytest.raises(ValueError):
        traverse.traverse(scene, ro, rd, act.float(), 1e-3, 1e9)


SPHERE_CASES = {
    "rtiow_smoke_scene": (lambda: presets.rtiow_smoke_scene(device="cpu"), {},
                          (0.0, 0.6, 2.0), 50),
    "sphere_light_scene": (lambda: presets.sphere_light_scene(device="cpu"),
                           {}, (0.0, 0.6, 2.0), 50),
    "volumetric_scene": (lambda: presets.volumetric_scene(device="cpu"), {},
                         (0.0, 0.6, 2.0), 50),
    "dof_motion": (lambda: presets.dof_motion_scene(sun=True, device="cpu"),
                   dict(aperture=0.2, time0=0.2, time1=0.8),
                   (0.0, 0.4, 1.2), 60),
    "env": (lambda: presets.env_sphere_scene(
        np.random.default_rng(5).uniform(0.0, 2.0, (8, 16, 3)).astype(
            np.float32), rotation_deg=30.0, scale=1.5, device="cpu"), {},
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
                      height=36, aperture=extra.get("aperture", 0.0),
                      device="cpu")
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


@pytest.mark.parametrize("walk", ["wide", "binary"])
@pytest.mark.parametrize("kind", ["closest", "any", "sun"])
def test_traverse_kernels_match_plain_versions(cuda, scene_cpu, kind, walk):
    """dsrt_traverse / dsrt_traverse_sun against their plain versions on
    the card: exact (t, u, v, tri) on closest hits, equal hit masks on
    any-hit queries, equal `blocked` on hit lanes; on the 8-ary walk and
    on the binary one (a scene deeper than the wide walk's stack)."""
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.ops.shade import sun_direction
    scene = scene_cpu.to(cuda)
    if walk == "binary":
        scene = dataclasses.replace(scene, wide_stack=tv.WIDE_STACK + 1)
    assert tv.walk_of(scene) == walk
    ro, rd = _rays(1 << 16, cuda)
    act = torch.from_numpy(np.random.default_rng(4).random(1 << 16) > 0.1
                           ).to(cuda)
    name = "dsrt_traverse_sun" if kind == "sun" else "dsrt_traverse"
    before = tv.LAUNCHES[name]
    inst = tv.INSTANCE_LAUNCHES[(kind, walk)]
    if kind == "sun":
        sdir = sun_direction(scene)
        got = tv.traverse_with_sun(scene, ro, rd, act, 1e-3, 1e9, sdir, 1e-3)
        want = tv.traverse_with_sun_plain(scene, ro, rd, act, 1e-3, 1e9, sdir,
                                          1e-3)
    else:
        got = tv.traverse(scene, ro, rd, act, 1e-3, 1e9,
                          any_hit=kind == "any")
        want = tv.traverse_plain(scene, ro, rd, act, 1e-3, 1e9,
                                 any_hit=kind == "any")
    torch.cuda.synchronize()
    assert tv.LAUNCHES[name] == before + 1
    assert tv.INSTANCE_LAUNCHES[(kind, walk)] == inst + 1
    hits = want[3] >= 0
    assert hits.sum() > 1000 and not hits[~act].any()
    assert torch.equal(got[3] >= 0, hits)
    if kind != "any":
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)
    if kind == "sun":
        assert got[4].dtype == torch.bool
        assert torch.equal(got[4][hits], want[4][hits])
        assert 0 < want[4][hits].sum() < hits.sum()


@pytest.mark.parametrize("fused_sun", [False, True], ids=["two", "fused"])
def test_split_frames_go_through_the_traverse_kernels(cuda, scene_cpu,
                                                      monkeypatch, fused_sun):
    """The wavefront loop on the card against the same loop on the CPU
    (the plain walk): identical accumulators and ray counts."""
    from dsrt_tpu_torch.exec_opts import OPTS
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.render import render_frame_wavefront
    monkeypatch.setattr(OPTS, "fused_sun", fused_sun)
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=12)
    cam = point_camera_at((-20.0, -30.0, -95.0), vfov=cfg.vfov, width=64,
                          height=36, device="cpu")
    tv.reset_launches()
    got, n = render_frame_wavefront(scene_cpu.to(cuda), cam.to(cuda), cfg,
                                    spp_batch=2, with_count=True)
    launched = dict(tv.LAUNCHES)
    want, n_cpu = render_frame_wavefront(scene_cpu, cam, cfg, spp_batch=2,
                                         with_count=True)
    assert launched["dsrt_traverse_sun" if fused_sun else "dsrt_traverse"] > 0
    assert launched["dsrt_traverse" if fused_sun else "dsrt_traverse_sun"] == 0
    np.testing.assert_array_equal(got, want)
    assert n == n_cpu


def _feature_case(name, tex_path):
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.scene import SceneBuilder
    fn, frm, at, vfov, extra = fs.CASES[name]
    scene = fn(SceneBuilder, Material, tex_path=tex_path).build(device="cpu")
    cam = make_camera(frm, at, vfov=vfov, width=64, height=36,
                      aperture=extra.get("aperture", 0.0), device="cpu")
    return scene, cam, RenderConfig(width=64, height=36, spp=2, max_depth=8,
                                    **extra)


@pytest.mark.parametrize("name", ["sphere_mix", "quad_light", "sphere_light",
                                  "cornell", "mesh_media", "mesh_media_light",
                                  "ptex", "dof", "motion_blur", "env",
                                  "smooth", "textured_spheres"])
def test_path_kernel_whole_scope_matches_plain_version(cuda, name, tmp_path):
    """Every feature case of the path kernel's wider scope: identical
    accumulators and ray counts against the plain version on the card
    (transcendentals in double rounded once on both sides, no
    contraction)."""
    tex = str(tmp_path / "panel.png")
    write_panel_texture(tex, size=16)
    scene_cpu, cam, cfg = _feature_case(name, tex)
    scene, cam_d = scene_cpu.to(cuda), cam.to(cuda)
    before = path_kernel.LAUNCHES["dsrt_path_render"]
    acc, n = path_kernel.path_render(scene, cam_d, cfg)
    torch.cuda.synchronize()
    assert path_kernel.LAUNCHES["dsrt_path_render"] == before + 1
    want, n_plain = path_kernel.path_render_plain(scene, cam_d, cfg, cfg.spp)
    assert torch.equal(acc, want)
    assert int(n) == int(n_plain)
    assert (want > 0).float().mean() > 0.05


def test_mixed_scenes_go_through_the_path_kernel(cuda):
    """render_frame_fused on CUDA mixed scenes launches the path kernel and
    no traversal kernel; a CUDA scene past the kernel's bounds raises."""
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.scene import SceneBuilder
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=8)
    cam = make_camera((0, 0.8, 2.6), (0, 0.3, -1), vfov=50, width=64,
                      height=36, device=cuda)
    path_kernel.reset_launches()
    traverse.reset_launches()
    for scene in (presets.mixed_scene(device=cuda),
                  presets.cornell_box_scene(device=cuda)):
        img, n = render_frame_fused(scene, cam, cfg, with_count=True)
        assert img.shape == (36, 64, 3) and n >= 64 * 36 * 2
    assert path_kernel.LAUNCHES["dsrt_path_render"] == 2
    assert sum(traverse.LAUNCHES.values()) == 0
    b = fs.sphere_mix(SceneBuilder, Material)
    for i in range(path_kernel.MAX_SPH):
        b.add_sphere((0.1 * i, 2.0, -3.0), 0.05, Material.lambertian())
    over = b.build(device=cuda)
    with pytest.raises(NotImplementedError):
        path_kernel.path_render(over, cam, cfg)
    with pytest.raises(NotImplementedError):
        render_frame_fused(over, cam, cfg)
    assert path_kernel.LAUNCHES["dsrt_path_render"] == 2


@pytest.mark.parametrize("fn", ["cos", "sin"])
def test_exact_math_matches_float64_calls_on_every_input(cuda, fn):
    from dsrt_tpu_torch.ops import exact_math
    r = exact_math.check(fn, cuda)
    assert r["vs_libdevice"] == 0 and r["vs_plain"] == 0


def test_path_kernel_deep_stack_matches_plain_version(cuda):
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.scene import SceneBuilder
    scene = fs.nested_triangles(SceneBuilder, Material).build(device=cuda)
    cfg = RenderConfig(width=32, height=18, spp=2, max_depth=6)
    cam = make_camera((0.0, 0.0, 2.0), (0.0, 0.0, -1.0), vfov=50, width=32,
                      height=18, device=cuda)
    assert 64 < scene.wide_stack <= path_kernel.WIDE_STACK
    acc_k, n_k = path_kernel.path_render(scene, cam, cfg)
    acc_p, n_p = path_kernel.path_render_plain(scene, cam, cfg, 2)
    assert torch.equal(acc_k, acc_p) and int(n_k) == int(n_p)


def test_frame_inputs_on_the_card_wait_for_nothing(cuda):
    """The driver's frames at Run A's settings on a 160x90 frame: on the
    card each camera field, the camera vector and the path kernel's sun
    vector carry the CPU path's bits, and frame_inputs plus
    render_frame_async over two frames, the second issued while the
    first is in flight, make no host-device synchronisation; nor at Run
    B's 1000 spp in 8 chunk launches a frame."""
    import os
    import chip_smoke
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.utils.pose import read_pose_file
    from dsrt_tpu_torch.utils.timing import StageTimer
    from dsrt_tpu_torch.utils.transform import pose_to_frame
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    poses = read_pose_file(os.path.join(root, "portbench", "data",
                                        "poses99.txt"))
    frames = [pose_to_frame(poses[i]) for i in (93, 94, 0, 49, 98)]
    base = ["--width", "160", "--height", "90", "--standin_detail", "12",
            "--standin_tex", os.path.join(root, "misc", "iss_standin.png")]
    args = driver.build_parser().parse_args(base + ["--spp", "250"])
    scene = driver.build_scene(args, StageTimer(), cuda)
    host = scene.to("cpu")
    cpu = torch.device("cpu")
    for frame in frames:
        s, cam = driver.frame_inputs(args, scene, frame, cuda)
        s_h, cam_h = driver.frame_inputs(args, host, frame, cpu)
        for f in ("origin", "lower_left", "horizontal", "vertical", "u",
                  "v", "w", "lens_radius", "vector"):
            got, want = getattr(cam, f), getattr(cam_h, f)
            if f == "vector":
                got, want = got(), want()
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), f
        assert torch.equal(
            path_kernel.sun_vector(s, 1e-3).cpu().view(torch.int32),
            path_kernel.sun_vector(s_h, 1e-3).view(torch.int32))
    assert chip_smoke.issue_syncs(args, scene, frames[:2], cuda) == 0
    args_b = driver.build_parser().parse_args(
        base + ["--spp", "1000",
                "--dispatch_rays", str(chip_smoke.RDV_SYNC_RUN_B_RAYS)])
    assert chip_smoke.issue_syncs(args_b, scene, frames[:2], cuda) == 0
