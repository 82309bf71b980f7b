"""A configuration's upscale stage: the seeded weights, the plain
reference against the program's network, tile grid and stitch, the
driver's arguments, and the stage judged through the harness in a tiny
cell on the CPU (a sound run, the control, the stage's faults, a deleted
output)."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from dsrt_tpu_torch.models import esrgan
from dsrt_tpu_torch.scripts import upsample
from dsrt_tpu_torch.utils import image_io
from portbench import faults, harness, reference_esrgan, weights
from portbench.registry import Bench
from portbench.tests import tinybench

RECIPE = {"init": "he_normal", "gain": 0.3, "conv_last_bias": 0.5}


def stage(num_feat=8, num_block=3, num_grow_ch=4, scale=4):
    return {"arch": "RRDBNet", "num_feat": num_feat, "num_block": num_block,
            "num_grow_ch": num_grow_ch, "scale": scale, "weights": RECIPE}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 4294967301])
def test_weights_reproduce_from_the_seed(seed):
    up = stage()
    a, b = weights.make(up, seed, "cpu"), weights.make(up, seed, "cpu")
    c = weights.make(up, seed + 1, "cpu")
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    assert torch.equal(a["conv_last.bias"], torch.full((3,), 0.5))
    assert not any(a[k].any() for k in a
                   if k.endswith(".bias") and k != "conv_last.bias")


def test_weights_follow_the_recipe():
    up = stage(num_feat=64, num_block=2, num_grow_ch=32)
    sd = weights.make(up, 11, "cpu")
    for name, fan_in in (("body.1.rdb3.conv5", (64 + 4 * 32) * 9),
                         ("conv_hr", 64 * 9)):
        w = sd[f"{name}.weight"]
        want = 0.3 * (2.0 / fan_in) ** 0.5
        assert abs(w.std().item() / want - 1) < 0.05
        assert abs(w.mean().item()) < 0.1 * want


def test_weights_load_with_the_program_loader(tmp_path):
    up = stage(num_block=2)
    path = weights.write(up, 2 ** 31 + 9, "cpu", str(tmp_path / "w.pth"))
    net = esrgan.load_torch_checkpoint(path, num_block=2, scale=4,
                                       device="cpu")
    sd = weights.make(up, 2 ** 31 + 9, "cpu")
    got = net.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert all(torch.equal(v, sd[k])
               for k, v in weights.load(path, "cpu").items())


@pytest.mark.parametrize("widths", [(8, 1, 4), (16, 3, 8)],
                         ids=["1_block", "3_blocks"])
def test_reference_equals_the_program_network(widths):
    nf, nb, gc = widths
    up = stage(nf, nb, gc)
    sd = weights.make(up, 2 ** 31 + 1, "cpu")
    net = esrgan.RRDBNet(num_feat=nf, num_block=nb, num_grow_ch=gc, scale=4)
    net.load_state_dict(sd)
    img = np.random.default_rng(3).integers(0, 256, (9, 16, 3), np.uint8)
    x = torch.from_numpy(reference_esrgan.to_float(img).transpose(2, 0, 1))
    with torch.no_grad():
        assert torch.equal(net.eval()(x[None]),
                           reference_esrgan.forward(sd, x[None], nb, 4))
    got = reference_esrgan.upscale_tiles(
        sd, reference_esrgan.to_float(img)[None], nb, 4, "cpu")[0]
    assert np.array_equal(got, esrgan.upscale_u8(net, img))


@pytest.mark.parametrize("shape", [(9, 16, 8, 2), (40, 72, 16, 4),
                                   (450, 800, 128, 8), (30, 30, 12, 3),
                                   (9, 16, 128, 8)])
def test_grid_and_stitch_are_the_program(shape):
    h, w, tile, overlap = shape
    rng = np.random.default_rng(5)
    img = rng.random((h, w, 3)).astype(np.float32)
    origins, th, tw = reference_esrgan.grid(h, w, tile, overlap)
    ours = reference_esrgan.tiles(img, origins, th, tw)
    if h <= tile and w <= tile:         # the program runs it whole
        assert origins == [(0, 0)] and np.array_equal(ours[0], img)
        return
    theirs, their_origins = esrgan.tile_grid(img, tile, overlap)
    assert origins == their_origins and np.array_equal(ours, theirs)
    some = sorted(rng.choice(len(origins), size=3, replace=False))
    assert np.array_equal(reference_esrgan.tiles(
        img, [origins[t] for t in some], th, tw), theirs[some])
    # the program's stitch of tiles that hold their own index
    ups = np.broadcast_to(np.arange(len(origins), dtype=np.float32)[
        :, None, None, None], (len(origins), 4 * tile, 4 * tile, 3))
    assert np.array_equal(
        reference_esrgan.owner(origins, h, w, th, tw, overlap, 4),
        esrgan.stitch(ups, origins, h, w, tile, overlap)[..., 0])


def test_whole_frame_when_tile_is_zero():
    origins, th, tw = reference_esrgan.grid(450, 800, 0, 8)
    assert (origins, th, tw) == ([(0, 0)], 450, 800)
    assert (reference_esrgan.owner(origins, 450, 800, th, tw, 8, 4) == 0).all()


@pytest.mark.parametrize("fault", [None, "altered", "missing"])
def test_tiled_stage_is_judged_tile_by_tile(tmp_path, fault):
    """The check on a tiled frame: the program's tiled upscale of a raw
    PNG, judged over a few tiles, reads 0; one output pixel altered in
    a judged tile, or a missing output, reads above 0."""
    from portbench import check
    up = dict(tinybench.UPSCALE, num_block=2, tile=16, overlap=4,
              check={"frames": 1, "tiles": 3,
                     "limits": {"up_mismatch_pct": 0.0}})
    path = weights.write(up, 21, "cpu", str(tmp_path / "w.pth"))
    net = esrgan.load_torch_checkpoint(path, num_block=2, device="cpu")
    raw = np.zeros((40, 72, 3), np.uint8)
    raw[10:30, 20:50] = np.random.default_rng(1).integers(0, 256, (20, 30, 3))
    out = esrgan.upscale_u8(net, raw, tile=16, overlap=4)
    image_io.write_png(str(tmp_path / "raw.png"), raw)
    cfg = {"width": 72, "height": 40, "upscale": up}
    seen = check.judge_upscale(cfg, [("", str(tmp_path / "raw.png"), "")],
                               [True], [True], 5, "cpu", "bf16", path)[1]
    pix = seen["first_mismatches"][0][2:4] if seen["first_mismatches"] \
        else None
    if fault == "altered":
        out[pix[0], pix[1], 1] ^= 1
    if fault != "missing":
        image_io.write_png(str(tmp_path / "up.png"), out)
    numbers, detail = check.judge_upscale(
        cfg, [("", str(tmp_path / "raw.png"), str(tmp_path / "up.png"))],
        [True], [fault != "missing"], 5, "cpu", None, path)
    assert detail["pixels_judged"] >= 3 * 8 * 8 * 16      # 3 interiors
    if fault is None:
        assert numbers["up_mismatch_pct"] == 0.0
    else:
        assert numbers["up_mismatch_pct"] > 0.0


PINNED = {
    "rdv_b_1080p_1000spp": ["--width", "1920", "--height", "1080", "--spp",
                            "1000"],
    "rdv_a_450p_250spp": ["--width", "800", "--height", "450", "--spp",
                          "250"],
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_driver_args_without_a_stage_are_unchanged(name):
    cfg = Bench().config(name)
    assert "upscale" not in cfg
    assert harness.driver_args(cfg, "P", "O", "T", 2 ** 31 + 5, "cuda") == [
        "--input_txt", "P", "--output_dir", "O", *PINNED[name],
        "--max_depth", "50", "--vfov", "40.0", "--gamma", "2.0",
        "--sun_radiance", "100000.0", "95000.0", "90000.0",
        "--seed", "2147483653", "--bvh", "sbvh", "--mode", "auto",
        "--dispatch_rays", "268435456", "--timings_tsv", "T",
        "--device", "cuda"]
    assert harness.final_dir(cfg, "O") == "O"


def test_driver_flags_are_appended_with_placeholders_filled():
    cfg = dict(Bench().config("rdv_a_450p_250spp"),
               upscale=dict(tinybench.UPSCALE, driver_flags=[
                   "--upscale", "--upscale_weights", "{weights}",
                   "--upscale_seed={seed}"]))
    base = harness.driver_args(Bench().config("rdv_a_450p_250spp"), "P", "O",
                               "T", 7, "cpu")
    assert harness.driver_args(cfg, "P", "O", "T", 7, "cpu", "w.pth") == \
        base + ["--upscale", "--upscale_weights", "w.pth", "--upscale_seed=7"]
    assert harness.final_dir(cfg, "O") == "O_upscaled"


@pytest.fixture
def program_reads_the_harness_weights(monkeypatch):
    """The program has no weights flag yet: its weight lookup,
    `scripts.upsample.fetch_weights`, returns the checkpoint the harness
    wrote in set-up, and nothing is downloaded."""
    written = []
    write = weights.write

    def spy(*a, **k):
        written.append(write(*a, **k))
        return written[-1]

    def refuse(*a, **k):
        raise OSError("no download here")
    monkeypatch.setattr(weights, "write", spy)
    monkeypatch.setattr(upsample, "fetch_weights",
                        lambda scale, allow_download=True: written[-1])
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    return written


@pytest.fixture(scope="module")
def tiny_x4(tmp_path_factory):
    return Bench(tinybench.make(tmp_path_factory.mktemp("tiny_x4"), width=16,
                                height=9, upscale=tinybench.UPSCALE))


def test_sound_stage_run_is_correct(tiny_x4,
                                    program_reads_the_harness_weights):
    res, run, verdict = harness.run_cell(tiny_x4, tinybench.TINY,
                                         2 ** 31 + 3, 0.5, False,
                                         device="cpu")
    assert res["correct"] is True, verdict
    assert verdict["numbers"] == {"frames_missing": 0,
                                  "px_mismatch_pct": 0.0,
                                  "up_mismatch_pct": 0.0}
    up = verdict["detail"]["upscale"]
    assert up["frames_judged"] == 2 and up["pixels_judged"] == 2 * 64 * 36
    assert up["u8_in_1_254_pct"] > 50
    assert res["check"]["up_mismatch_pct"] == {"value": 0.0, "limit": 5.0}
    assert "upscale_weights" in run.setup_phases
    assert program_reads_the_harness_weights
    assert res["failed"] == 0 and run.written == len(run.frames) >= 3
    for f in run.frames:
        assert f.final == os.path.join(os.path.dirname(f.png) + "_upscaled",
                                       os.path.basename(f.png))
        assert f.wait_s is not None


def test_stage_control_is_not_correct(tiny_x4,
                                      program_reads_the_harness_weights):
    res, _, verdict = harness.run_cell(tiny_x4, tinybench.TINY, 12, 0.5,
                                       False, device="cpu", control="bf16")
    assert res["correct"] is False
    assert verdict["numbers"]["up_mismatch_pct"] > \
        verdict["limits"]["up_mismatch_pct"]


@pytest.mark.parametrize("fault", ["upstale", "bicubic", "noblock"],
                         ids=["state_unchanged", "stage_replaced",
                              "block_left_out"])
def test_broken_stage_is_not_correct(tiny_x4, monkeypatch, fault,
                                     program_reads_the_harness_weights):
    monkeypatch.setattr(esrgan, "upscale_u8", esrgan.upscale_u8)
    faults.plant(fault)
    res, _, verdict = harness.run_cell(tiny_x4, tinybench.TINY, 2 ** 31 + 3,
                                       0.5, False, device="cpu")
    assert res["correct"] is False, verdict
    assert verdict["numbers"]["up_mismatch_pct"] > \
        verdict["limits"]["up_mismatch_pct"]
    assert verdict["numbers"]["px_mismatch_pct"] == 0.0


def test_missing_upscaled_png_is_not_correct(tiny_x4, monkeypatch,
                                             program_reads_the_harness_weights):
    orig = image_io.write_png
    count = []

    def write_png(path, img):
        if os.path.basename(os.path.dirname(path)).endswith("_upscaled"):
            count.append(path)
            if len(count) == 2:
                return
        orig(path, img)
    monkeypatch.setattr(image_io, "write_png", write_png)
    res, run, verdict = harness.run_cell(tiny_x4, tinybench.TINY, 4, 0.5,
                                         False, device="cpu")
    assert verdict["numbers"]["frames_missing"] >= 1
    assert res["correct"] is False and res["failed"] >= 1
    assert run.written == len(run.frames) - res["failed"]



def test_stage_calibration_reads_the_stage(tmp_path):
    """The calibration tool at a tiny size: a sound run reads 0, the
    bfloat16 control does not, and the program's weight lookup is left
    as it was."""
    from portbench import stage_calibration
    lookup = upsample.fetch_weights
    out = tmp_path / "readings.jsonl"
    stage_calibration.main([
        "--out", str(out), "--device", "cpu", "--sound", "1",
        "--controls", "1", "--faults", "--poses", "97", "99",
        "--stage", json.dumps({k: tinybench.UPSCALE[k] for k in
                               ("num_feat", "num_grow_ch", "check")}),
        "--changes", json.dumps(
            {"width": 16, "height": 9, "spp": 2, "standin_detail": 1,
             "dispatch_rays": 288, "check": {
                 "frames": 1, "candidates": 256, "lit_pixels": 8,
                 "any_pixels": 4, "limits": {"frames_missing": 0,
                                             "px_mismatch_pct": 5.0}}})])
    rows = {r["kind"]: r
            for r in map(json.loads, out.read_text().splitlines())}
    assert set(rows) == {"sound", "bf16", "tf32"}
    assert rows["sound"]["numbers"]["up_mismatch_pct"] == 0.0
    assert rows["bf16"]["numbers"]["up_mismatch_pct"] > 5.0
    assert rows["sound"]["upscale"]["u8_in_1_254_pct"] > 50
    assert upsample.fetch_weights is lookup
