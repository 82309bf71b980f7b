"""The check that decides `correct`: the reference against the program's
plain version, the control, and a run with the timed path broken
underneath (the program's plain versions on the CPU, a tiny cell)."""

import numpy as np
import pytest
import torch

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.render import render_accum_fused, tonemap_device
from dsrt_tpu_torch.utils.pose import parse_pose_lines
from dsrt_tpu_torch.utils.transform import pose_to_frame
from portbench import faults, harness, pngio, poses, reference, standin
from portbench.registry import Bench
from portbench.tests import tinybench

TEX = str(Bench().data("data/iss_standin.png"))
LINES = poses.read_pose_lines(str(Bench().data("data/poses99.txt")))
RCFG = {"max_depth": 50, "rr_start_depth": 5, "rr_max_p": 0.95,
        "shadow_bias": 1e-3, "sun_radiance": (1e5, 9.5e4, 9e4), "gamma": 2.0,
        "firefly_clamp": 10.0}


@pytest.fixture(scope="module")
def scene_and_mesh():
    from dsrt_tpu_torch.models.scene import SceneBuilder
    mesh = standin.standin_mesh(2, TEX)
    b = SceneBuilder(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0),
                     sun_radiance=(1e5, 9.5e4, 9e4), seed=2 ** 31 + 9,
                     bvh_method="sbvh")
    b.add_mesh(harness.program_mesh(mesh))
    return b.build(device="cpu"), mesh


@pytest.mark.parametrize("k", [98, 95, 93])
def test_reference_equals_the_program_plain_version(scene_and_mesh, k):
    scene, mesh = scene_and_mesh
    w, h, spp = 72, 40, 6
    budget = w * h * 4           # chunks of 4 and 2 samples, salted
    cfg = RenderConfig(width=w, height=h, spp=spp, seed=scene.seed)
    fr = pose_to_frame(parse_pose_lines([LINES[k]])[0])
    cam = point_camera_at(fr.cam_in_model, (0.0, 0.0, 0.0), vfov=40.0,
                          width=w, height=h, device="cpu")
    acc, _ = render_accum_fused(scene.with_sun(fr.sun_dir_model), cam, cfg,
                                budget)
    img = tonemap_device(acc, cfg, spp).numpy()
    ctx = reference.Ctx("cpu")
    tb = reference.Tables(mesh, pngio.read_rgb8(TEX), ctx)
    pix = [(x, y) for y in range(h) for x in range(w)]
    got = reference.render_pixels(ctx, tb, [(LINES[k], 40.0, pix)], w, h,
                                  spp, scene.seed, budget, RCFG)[0].numpy()
    want = np.stack([img[h - 1 - y, x] for x, y in pix])
    assert (want > 0).any()
    assert np.array_equal(got, want)


def test_chunk_schedule_is_the_program():
    from dsrt_tpu_torch.render import fused_chunk_spp
    cfg = RenderConfig(width=1920, height=1080, spp=1000)
    sched = reference.chunk_schedule(1920, 1080, 1000, 256 * 1024 * 1024)
    assert [s for s, _ in sched] == [129] * 7 + [97]
    assert sched[0][0] == fused_chunk_spp(cfg)
    assert sched[1][1] == 0x9E3779B9 and sched[0][1] == 0
    assert reference.chunk_schedule(800, 450, 250, 256 * 1024 * 1024) == \
        [(250, 0)]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Bench(tinybench.make(tmp_path_factory.mktemp("tiny")))


def test_sound_run_is_correct(tiny):
    res, run, verdict = harness.run_cell(tiny, tinybench.TINY, 2 ** 31 + 3,
                                         0.5, False, device="cpu")
    assert res["correct"] is True, verdict
    assert verdict["numbers"] == {"frames_missing": 0, "px_mismatch_pct": 0.0}
    assert verdict["detail"]["pixels_judged"] > 0
    assert set(res["metrics"]) == {"s_per_frame.rdv_b", "setup_s"}


def test_control_is_not_correct(tiny):
    res, _, verdict = harness.run_cell(tiny, tinybench.TINY, 11, 0.5, False,
                                       device="cpu", control="bf16")
    assert res["correct"] is False
    assert verdict["numbers"]["px_mismatch_pct"] > \
        verdict["limits"]["px_mismatch_pct"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"],
                         ids=["state_unchanged", "half_the_samples",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(driver, "render_frame_async", driver.render_frame_async)
    faults.plant(fault)
    res, _, verdict = harness.run_cell(tiny, tinybench.TINY, 2 ** 31 + 3,
                                       0.5, False, device="cpu")
    assert res["correct"] is False, verdict


def test_missing_frame_is_not_correct(tiny, monkeypatch):
    orig = driver.encode
    count = []

    def encode(png, img, timer, args):
        count.append(png)
        if len(count) != 2:
            orig(png, img, timer, args)
    monkeypatch.setattr(driver, "encode", encode)
    res, _, verdict = harness.run_cell(tiny, tinybench.TINY, 4, 0.5, False,
                                       device="cpu")
    assert verdict["numbers"]["frames_missing"] >= 1
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.cuda
def test_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, _, verdict = harness.run_cell(Bench(), "rdv_a.close6", 2 ** 31 + 17,
                                       2.0, False)
    assert res["correct"] is True, verdict
    assert res["device"]["platform"] == "gpu"
