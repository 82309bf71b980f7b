"""A configuration's upscale stage: the seeded weights, the plain
reference against the program's network, tile grid and stitch, the
driver's arguments, the stage judged through the harness in a tiny cell
on the CPU (a sound run, the control, the stage's faults, a deleted
output), an architecture added by files alone, and RRDBNet's weights,
reference and work as they were before architectures were files."""

import hashlib
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from dsrt_tpu_torch.models import esrgan
from dsrt_tpu_torch.scripts import upsample
from dsrt_tpu_torch.utils import image_io
from portbench import faults, harness, reference_esrgan, registry, weights
from portbench import work_esrgan
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
        sd, reference_esrgan.to_float(img)[None], up, "cpu")[0]
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
    """The checkpoints the program loads, in order: the driver gets the
    one the harness wrote in set-up through `--upscale_weights
    {weights}`; its own weight lookup and downloading raise."""
    loaded = []
    load = esrgan.load_torch_checkpoint

    def spy(path, *a, **k):
        loaded.append(path)
        return load(path, *a, **k)

    def refuse(*a, **k):
        raise OSError("no download here")
    monkeypatch.setattr(esrgan, "load_torch_checkpoint", spy)
    monkeypatch.setattr(upsample, "fetch_weights", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    return loaded


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
    loaded = program_reads_the_harness_weights
    assert loaded and all(os.path.basename(p) == "upscale.pth"
                          for p in loaded)
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
    monkeypatch.setattr(esrgan, "upscale_u8_async", esrgan.upscale_u8_async)
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



def test_stage_calibration_reads_the_stage(tmp_path, monkeypatch):
    """The calibration tool at a tiny size, on rdv_a_x4's stage (its
    depth, recipe, grid and `--upscale_weights {weights}`) at narrow
    widths: a sound run reads 0, the bfloat16 control does not, and the
    program's weight lookup is left as it was."""
    from portbench import stage_calibration

    def refuse(*a, **k):
        raise OSError("no download here")
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    lookup = upsample.fetch_weights
    out = tmp_path / "readings.jsonl"
    stage_calibration.main([
        "--out", str(out), "--device", "cpu", "--config", "rdv_a_x4",
        "--sound", "1",
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


def test_stage_calibration_refuses_a_configuration_without_a_stage(tmp_path):
    from portbench import stage_calibration
    with pytest.raises(SystemExit):
        stage_calibration.main(["--out", str(tmp_path / "r.jsonl"),
                                "--config", "rdv_a_450p_250spp"])


# An architecture of two convs, as a later configuration adds one: its file
# under stages/, named by the configuration's upscale.arch.
TWO_CONV = '''"""Two convs: conv_first (3 -> num_feat, 3x3), leaky ReLU 0.2,
nearest x scale, conv_hr (num_feat -> 3, 3x3)."""
from collections import OrderedDict

import torch
import torch.nn.functional as F


def shapes(up):
    nf = int(up["num_feat"])
    return [("conv_first", nf, 3), ("conv_hr", 3, nf)]


def make_weights(up, seed, device):
    rec = up["weights"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sd = OrderedDict()
    for name, co, ci in shapes(up):
        std = float(rec["gain"]) * (2.0 / (ci * 9)) ** 0.5
        sd[name + ".weight"] = std * torch.randn(
            co, ci, 3, 3, generator=gen, device=device)
        sd[name + ".bias"] = torch.full((co,), float(rec["bias"]),
                                        device=device)
    return sd


def forward(sd, x, up):
    y = F.leaky_relu(F.conv2d(x, sd["conv_first.weight"],
                              sd["conv_first.bias"], padding=1), 0.2)
    y = F.interpolate(y, scale_factor=int(up["scale"]), mode="nearest")
    return F.conv2d(y, sd["conv_hr.weight"], sd["conv_hr.bias"], padding=1)


def tile_flops(up, th, tw):
    area = {"conv_first": 1, "conv_hr": int(up["scale"]) ** 2}
    return float(sum(2 * 9 * co * ci * area[name] * th * tw
                     for name, co, ci in shapes(up)))


def param_count(up):
    return sum(co * (ci * 9 + 1) for _, co, ci in shapes(up))
'''

# the limit 0: on the CPU the program's network is the reference's
# arithmetic, and sound runs read 0; two convs see few pixels, so a stale
# frame differs from the due one on a few percent of the output only
TWO_CONV_STAGE = dict(tinybench.UPSCALE, arch="TwoConv", num_feat=8,
                      weights={"gain": 1.0, "bias": 0.5},
                      check={"frames": 2, "tiles": 4,
                             "limits": {"up_mismatch_pct": 0.0}})
for _key in ("num_block", "num_grow_ch"):
    del TWO_CONV_STAGE[_key]


class TwoConvNet(torch.nn.Module):
    """The program's side of TWO_CONV, standing in for the network that
    the change adding such an architecture to the program would bring:
    the attributes the program's tile path reads (`scale`, `conv_hr`)."""

    def __init__(self, sd: dict, scale: int):
        super().__init__()
        nf = sd["conv_first.weight"].shape[0]
        self.scale = scale
        self.conv_first = torch.nn.Conv2d(3, nf, 3, 1, 1)
        self.conv_hr = torch.nn.Conv2d(nf, 3, 3, 1, 1)
        self.load_state_dict(sd)

    def forward(self, x):
        y = torch.nn.functional.leaky_relu(self.conv_first(x), 0.2)
        y = torch.nn.functional.interpolate(y, scale_factor=self.scale,
                                            mode="nearest")
        return self.conv_hr(y)


def _tree(root) -> dict:
    base = root / "portbench"
    return {str(f.relative_to(base)): f.read_bytes()
            for f in sorted(base.rglob("*")) if f.is_file()
            and "__pycache__" not in f.parts and "tests" not in f.parts}


def _appends_only(old, new) -> bool:
    """`new` is `old` with entries appended to its lists (at any depth)."""
    if isinstance(old, dict):
        return isinstance(new, dict) and set(old) == set(new) and all(
            _appends_only(old[k], new[k]) for k in old)
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(
            _appends_only(a, b) for a, b in zip(old, new))
    return old == new


@pytest.mark.parametrize("fault", [None, "upstale"],
                         ids=["sound", "state_unchanged"])
def test_an_architecture_is_added_by_files(tmp_path, monkeypatch, fault):
    """A configuration naming an architecture of its own, TwoConv, with its
    file under stages/ and a cell over it, all added to a copy as files;
    the program runs the network through its stage (its loader pointed at
    TwoConvNet).  The copy adds files and entries only; a CPU window is
    judged correct, and not correct with `upstale` planted."""
    root = tinybench.make(tmp_path, width=16, height=9,
                          upscale=TWO_CONV_STAGE,
                          files={"stages/TwoConv.py": TWO_CONV})
    here, there = _tree(registry.REPO), _tree(root)
    assert all(there.get(k) == v for k, v in here.items())
    assert set(there) - set(here) == {"stages/TwoConv.py", "configs/tiny.json",
                                      "traffic/tail3.json"}
    assert _appends_only(
        json.loads((registry.REPO / "BENCHMARK.json").read_text()),
        json.loads((root / "BENCHMARK.json").read_text()))
    with pytest.raises(ValueError, match="TwoConv.py"):
        weights.make(TWO_CONV_STAGE, 1, "cpu")      # not in the tree

    def load(path, num_block=23, scale=4, device=None):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return TwoConvNet(sd, scale).to(device)

    def refuse(*a, **k):
        raise OSError("no download here")
    monkeypatch.setattr(esrgan, "load_torch_checkpoint", load)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    if fault:
        monkeypatch.setattr(esrgan, "upscale_u8_async",
                            esrgan.upscale_u8_async)
        faults.plant(fault)
    res, run, verdict = harness.run_cell(Bench(root), tinybench.TINY,
                                         2 ** 31 + 7, 0.5, False,
                                         device="cpu")
    up = verdict["detail"]["upscale"]
    assert up["frames_judged"] == 2 and up["u8_in_1_254_pct"] > 50
    if fault is None:
        assert res["correct"] is True, verdict
        assert verdict["numbers"]["up_mismatch_pct"] == 0.0
    else:
        assert res["correct"] is False, verdict
        assert verdict["numbers"]["up_mismatch_pct"] > \
            verdict["limits"]["up_mismatch_pct"]
        assert verdict["numbers"]["px_mismatch_pct"] == 0.0
    cfg = Bench(root).config("tiny")
    assert work_esrgan.frame_flops(cfg, root) == 2 * 9 * (8 * 3 + 3 * 8 * 16) \
        * 16 * 9
    assert work_esrgan.frame_bytes(cfg, root) == 4 * (
        8 * 28 + 3 * 73 + 16 * 9 * (3 + 3 * 16))


def test_unknown_architecture_names_the_file_looked_for():
    with pytest.raises(ValueError, match=r"stages/NoSuchNet\.py"):
        weights.make(dict(tinybench.UPSCALE, arch="NoSuchNet"), 1, "cpu")
    with pytest.raises(ValueError, match="unknown stage architecture"):
        registry.stage("../configs/rdv_a_x4")


# sha256 over each entry's name, shape and float32 bytes, in order, of
# weights.make(rdv_a_x4's upscale, seed, "cpu") at the commit before
# architectures became files
RDV_A_X4_WEIGHTS = {
    3180000000: "db94008aa36ebf5243ca9827a582192314e91da65cd1a870951ff65d162ff852",
    2 ** 31 + 17: "ba622cd073abb97a91401b24fafef7fd6bf4ebb4df7924e9276a3eaef0d1cac4",
}


@pytest.mark.parametrize("seed", sorted(RDV_A_X4_WEIGHTS))
def test_rrdbnet_weights_are_unchanged(seed):
    sd = weights.make(Bench().config("rdv_a_x4")["upscale"], seed, "cpu")
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    assert len(sd) == 702 and h.hexdigest() == RDV_A_X4_WEIGHTS[seed]


def test_rrdbnet_work_is_unchanged():
    cfg = Bench().config("rdv_a_x4")
    assert work_esrgan.frame_flops(cfg) == 16_447_954_747_392
    assert work_esrgan.frame_bytes(cfg) == 160_377_356
    assert work_esrgan.frame_bound_s(cfg) == pytest.approx(0.245491862,
                                                           rel=1e-9)


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_stage_forward_is_the_reference(scale):
    up = stage(num_feat=8, num_block=2, num_grow_ch=4, scale=scale)
    arch = registry.stage("RRDBNet")
    sd = arch.make_weights(up, 2 ** 31 + 3, "cpu")
    assert list(sd) == list(weights.make(up, 2 ** 31 + 3, "cpu"))
    x = torch.rand(2, 3, 12, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(arch.forward(sd, x, up),
                           reference_esrgan.forward(sd, x, 2, scale))
    assert arch.tile_flops(up, 12, 16) == \
        work_esrgan.flops_per_input_pixel(up) * 12 * 16
