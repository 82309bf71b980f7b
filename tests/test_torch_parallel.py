"""The port's sharded renders (dsrt_tpu_torch/parallel/) on CPU ranks.

Four ranks join over gloo (torch.multiprocessing.spawn, one thread a
rank) and render the frames of `JOBS` once for the module; the tests
hold them bit for bit against the port's single-process references, and
those against JAX's sharded render on the 8 virtual CPU
devices of tests/conftest.py (the XLA path, OPTS.pallas "off", as in
tests/test_parallel.py).  Port against JAX uses the whole-frame
tolerance: >= 99% identical pixels and mean |d| <= 0.5 u8.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
from dsrt_tpu_torch.models.presets import rtiow_smoke_scene
from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
from dsrt_tpu_torch.parallel import mesh as meshmod
from dsrt_tpu_torch.parallel.dryrun import Job, render_jobs
from dsrt_tpu_torch.parallel.mesh import (RankMesh, auto_sp, backend_for,
                                          make_mesh, mesh_shape, spawn_ranks)
from dsrt_tpu_torch.parallel.render import (packet_shard,
                                            render_frame_fused_sharded,
                                            render_frame_sharded,
                                            render_frame_sp_emulated)
from dsrt_tpu_torch.render import (PACKET, lane_layout, render_frame,
                                   render_frame_fused)

CPUS = jax.devices("cpu")
RANKS = 4
RANKS_TIMEOUT = 240     # seconds for the four ranks' frames
# rtiow as tests/test_parallel.py renders it; the detail-1 stand-in so
# that the traversal wrappers run
SPECS = {"rtiow": (rtiow_smoke_scene,
                   partial(make_camera, (0, 0.4, 1.5), (0, 0, -1), vfov=55)),
         "standin": (partial(iss_standin_scene, detail=1),
                     partial(point_camera_at, (20.0, 30.0, 95.0),
                             vfov=40.0))}
CFG = {"rtiow": RenderConfig(width=40, height=24, spp=4, max_depth=6),
       "standin": RenderConfig(width=48, height=24, spp=4, max_depth=6)}
# 32x16 is one lane packet: three of the four ranks hold only padding
FUSED_CFG = RenderConfig(width=32, height=16, spp=1, max_depth=3)


def camera_spec(camera, cfg):
    return partial(camera, width=cfg.width, height=cfg.height)


JOBS = ([Job(f"{name} sp{sp}", SPECS[name][0],
             camera_spec(SPECS[name][1], CFG[name]), CFG[name], sp=sp)
         for name in ("rtiow", "standin") for sp in (1, 2, 4)]
        + [Job(f"{name} fused", SPECS[name][0],
               camera_spec(SPECS[name][1], FUSED_CFG), FUSED_CFG,
               fused=True) for name in ("rtiow", "standin")])


def build(name, cfg):
    if name == "rtiow":
        scene = rtiow_smoke_scene(device="cpu")
        cam = make_camera((0, 0.4, 1.5), (0, 0, -1), vfov=55,
                          width=cfg.width, height=cfg.height, device="cpu")
    else:
        scene = iss_standin_scene(detail=1, device="cpu")
        cam = point_camera_at((20.0, 30.0, 95.0), vfov=40.0,
                              width=cfg.width, height=cfg.height,
                              device="cpu")
    return scene, cam


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks") / "jobs.pt")
    spawn_ranks(render_jobs, RANKS, JOBS, out, "cpu", threads=1,
                timeout=RANKS_TIMEOUT)
    return torch.load(out, weights_only=False)


def frame_agreement(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return float((d.max(-1) == 0).mean()), float(d.mean())


# (a) mesh rules

def test_mesh_rules():
    assert mesh_shape(4, 2) == (2, 2) and mesh_shape(4, 4) == (4, 1)
    assert mesh_shape(3, 1) == (1, 3)
    for n, sp in ((4, 3), (6, 4), (3, 2), (4, 0)):
        with pytest.raises(ValueError, match="must divide"):
            mesh_shape(n, sp)
    assert [auto_sp(n) for n in (1, 2, 3, 4, 6, 8)] == [1, 2, 1, 2, 2, 2]


def test_make_mesh_refuses_before_joining():
    # one process with no torch.distributed.run environment is one rank
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(sp=2, device="cpu")
    with pytest.raises(ValueError, match="spans all 1 ranks"):
        make_mesh(4, device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_rule(monkeypatch):
    assert backend_for(torch.device("cpu"), 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(torch.device("cuda", 0), 2)[0] == "nccl"
    assert backend_for(torch.device("cuda", 0), 3)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for(torch.device("cuda", 0), 2)[0] == "gloo"


def test_cuda_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        meshmod.rank_device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(device="cuda")


def test_sharded_value_errors():
    scene, cam = build("rtiow", CFG["rtiow"])
    # the checks come before any collective: no process group is needed
    mesh = RankMesh(sp=2, dp=1, rank=0, device=torch.device("cpu"),
                    backend="gloo", device_mesh=None)
    with pytest.raises(ValueError, match="divisible by sp=2"):
        render_frame_sharded(scene, cam, RenderConfig(width=40, height=24,
                                                      spp=3), mesh)
    with pytest.raises(ValueError, match="dp-only"):
        render_frame_fused_sharded(scene, cam, FUSED_CFG, mesh)
    with pytest.raises(ValueError, match="must divide spp"):
        render_frame_sp_emulated(scene, cam, RenderConfig(
            width=40, height=24, spp=3), sp=2)


@pytest.mark.parametrize("w,h,dp", [(800, 450, 2), (40, 24, 4), (32, 16, 4),
                                    (48, 24, 3), (100, 70, 5)])
def test_packet_shard_is_a_block_of_the_padded_lane_layout(w, h, dp):
    px, py, valid, (ty, tx) = lane_layout(w, h)
    k = px.shape[0]
    k_loc = -(-k // dp)
    dead = np.zeros((k_loc * dp - k, PACKET), bool)
    valid = np.concatenate([valid, dead])
    flat = np.concatenate([py * w + px, dead.astype(np.int64)])
    for d in range(dp):
        pix, live, layout = packet_shard(w, h, dp, d)
        rows = slice(d * k_loc, (d + 1) * k_loc)
        assert layout == (ty, tx, k)
        np.testing.assert_array_equal(live, valid[rows].reshape(-1))
        np.testing.assert_array_equal(pix[live], flat[rows].reshape(-1)[live])


# (b) sharded ranks against the port's single-process references

@pytest.mark.parametrize("name", ["rtiow", "standin"])
def test_dp4_equals_render_frame(sharded, name):
    scene, cam = build(name, CFG[name])
    ref = render_frame(scene, cam, CFG[name])
    got = sharded[f"{name} sp1"]["img"]
    assert (got > 0).mean() > 0.01
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ["rtiow", "standin"])
def test_sp_sharded_equals_emulation(sharded, name, sp):
    scene, cam = build(name, CFG[name])
    want = render_frame_sp_emulated(scene, cam, CFG[name], sp=sp)
    np.testing.assert_array_equal(sharded[f"{name} sp{sp}"]["img"], want)
    # the slices are decorrelated: not the dp-only image
    assert not np.array_equal(want, sharded[f"{name} sp1"]["img"])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ["rtiow", "standin"])
def test_sp_emulation_walks_agree(name, sp):
    """The emulation through the traversal wrappers equals the one
    through the plain walk (the reference the card's check uses)."""
    scene, cam = build(name, CFG[name])
    np.testing.assert_array_equal(
        render_frame_sp_emulated(scene, cam, CFG[name], sp=sp),
        render_frame_sp_emulated(scene, cam, CFG[name], sp=sp, walk="plain"))


@pytest.mark.parametrize("name", ["rtiow", "standin"])
def test_fused_dp4_with_padding_ranks_equals_fused(sharded, name):
    scene, cam = build(name, FUSED_CFG)
    ref, rays = render_frame_fused(scene, cam, FUSED_CFG, with_count=True)
    got = sharded[f"{name} fused"]
    np.testing.assert_array_equal(got["img"], ref)
    assert got["rays"] == rays
    ranks = got["ranks"]
    assert [r["pixels"] for r in ranks] == [32 * 16, 0, 0, 0]
    # CPU tensors take the plain versions, which launch no kernel
    assert all(not any(r["launches"].values()) for r in ranks)


def test_sp_ranks_hold_their_slices(sharded):
    ranks = sharded["standin sp2"]["ranks"]
    assert [(r["sp_index"], r["dp_index"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    # both rows render the same dp shards
    assert ranks[0]["pixels"] == ranks[2]["pixels"]
    assert sum(r["pixels"] for r in ranks[:2]) == 48 * 24


def test_dryrun_multichip_on_cpu_ranks():
    from dsrt_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(RANKS, "cpu")


def test_dryrun_cli_without_a_card_raises(monkeypatch):
    """The dry run's CLI runs on the card unless --device says otherwise:
    with no card it raises, naming CUDA, before a rank starts."""
    from dsrt_tpu_torch.parallel import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "spawn_ranks", lambda *a, **k: pytest.fail(
        "ranks spawned without a card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--ranks", "2"])


# (c) the port against JAX's sharded render

@pytest.fixture(scope="module")
def jax_rtiow():
    from dsrt_tpu.exec_opts import OPTS
    from dsrt_tpu.models.presets import rtiow_smoke_scene as jax_rtiow_scene
    from dsrt_tpu.ops.camera import make_camera as jax_camera
    old = OPTS.pallas
    OPTS.pallas = "off"
    try:
        with jax.default_device(CPUS[0]):
            cfg = CFG["rtiow"]
            from dsrt_tpu.config import RenderConfig as JaxConfig
            jcfg = JaxConfig(width=cfg.width, height=cfg.height,
                             spp=cfg.spp, max_depth=cfg.max_depth)
            yield (jax_rtiow_scene(),
                   jax_camera((0, 0.4, 1.5), (0, 0, -1), vfov=55,
                              width=cfg.width, height=cfg.height), jcfg)
    finally:
        OPTS.pallas = old


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_sharded_matches_jax(sharded, jax_rtiow, sp):
    """sp = 4 also checks the masked slice mix against the product that
    wraps in JAX's sharded body (JAX's own emulation cannot run it)."""
    from dsrt_tpu.parallel.mesh import make_mesh as jax_mesh
    from dsrt_tpu.parallel.render import render_frame_sharded as jax_sharded
    jscene, jcam, jcfg = jax_rtiow
    with jax.default_device(CPUS[0]):
        want = jax_sharded(jscene, jcam, jcfg,
                           jax_mesh(8, sp=sp, devices=CPUS))
    scene, cam = build("rtiow", CFG["rtiow"])
    for got in (render_frame_sp_emulated(scene, cam, CFG["rtiow"], sp=sp),
                sharded[f"rtiow sp{sp}"]["img"]):
        same, mean_d = frame_agreement(got, want)
        assert same >= 0.99 and mean_d <= 0.5, (same, mean_d)
