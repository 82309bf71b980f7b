"""The driver's x4 upscale stage inside the frame loop (`--upscale
--upscale_weights`), on the CPU, against the benchmark's plain reference
(portbench/reference_esrgan.py) on seeded weights: RRDBNet, and SwinIR
through the same loop.

The network has RealESRGAN_x4plus's depth (23 RRDBs, as the checkpoint
loader builds them) at narrow widths (8 features, 4 growth channels),
with portbench/weights.py's recipe (He-normal x 0.3, `conv_last` bias
0.5).  The frame, 160x90, is wider than one 128-pixel tile, so the tile
grid (2 tiles) and the stitch run.

Tolerances, the program's upscaled PNG against the reference on the
program's own raw PNG: u8 equal on >= 99.9% of values and max |d| <= 1,
and in float max |d| <= 1e-5 x max |out|: both are FP32 with the same
equations, but two conv call paths (a batch of tiles, one tile a call)
may sum in other orders.  The reference in bfloat16 fails them.

SwinIR (portbench/stages/SwinIR.py, `rdv_a_swinir`'s recipe) at 48 wide,
2 RSTBs of 2 layers, on 44x26 frames: one tile, which the network
reflect-pads to 48x32 and crops; its PNGs against the reference's u8 on
the program's raw PNG with the same u8 tolerance, which the reference in
bfloat16 fails.
"""

import os
import urllib.request

import numpy as np
import pytest
import torch

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.models import esrgan
from dsrt_tpu_torch.scripts import upsample
from dsrt_tpu_torch.utils import image_io, timing
from portbench import reference_esrgan as rup
from portbench import weights
from portbench.harness import Frame, Run
from portbench.registry import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSES = os.path.join(ROOT, "portbench", "data", "poses99.txt")
STAGE = {"arch": "RRDBNet", "num_feat": 8, "num_block": 23,
         "num_grow_ch": 4, "scale": 4,
         "weights": {"init": "he_normal", "gain": 0.3,
                     "conv_last_bias": 0.5}}
SEED = 2 ** 31 + 19
W, H, TILE, OVERLAP = 160, 90, 128, 8
ARGS = ["--device", "cpu", "--width", str(W), "--height", str(H), "--spp",
        "2", "--max_depth", "3", "--standin_detail", "1"]
STAGE_SPANS = ("upscale_load", "upscale", "upscale_forward",
               "upscale_encode", "upscale_finish", "upscale_drain")
SWIN_SPANS = ("swin_rstb", "swin_attn")
SWIN = dict(Bench().config("rdv_a_swinir")["upscale"], embed_dim=48,
            depths=[2, 2], num_heads=[8, 8])
SW, SH = 44, 26


def _pose_file(tmp, first=97, n=2):
    """n close, lit poses of the rendezvous (lines first..first+n-1)."""
    with open(POSES) as fh:
        lines = [ln for ln in fh if not ln.startswith("#")]
    path = os.path.join(str(tmp), "poses.txt")
    with open(path, "w") as fh:
        fh.write("".join(lines[first:first + n]))
    return path


class _Kept(timing.StageTimer):
    made = []

    def __init__(self):
        super().__init__()
        self.made.append(self)


def _drive(monkeypatch, tmp, extra, n=2):
    """Run the driver over the last n poses with a timer kept;
    returns (timer, output dir, the PNG writes in order)."""
    writes = []
    real = image_io.write_png

    def write_png(path, img):
        writes.append(path)
        real(path, img)
    _Kept.made = []
    monkeypatch.setattr(driver, "StageTimer", _Kept)
    monkeypatch.setattr(image_io, "write_png", write_png)
    out = os.path.join(str(tmp), "frames")
    assert driver.main(ARGS + ["--input_txt", _pose_file(tmp, 99 - n, n),
                               "--output_dir", out, *extra]) == 0
    assert len(_Kept.made) == 1
    return _Kept.made[0], out, writes


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads for the convs, so that this module leaves the other
    test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return weights.write(STAGE, SEED, "cpu", str(
        tmp_path_factory.mktemp("w") / "x4.pth"))


@pytest.fixture(scope="module")
def staged(tmp_path_factory, ckpt):
    """One driver run of 2 frames with the stage on the seeded
    checkpoint, downloading refused."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("staged")
    try:
        mp.setattr(urllib.request, "urlretrieve", _refuse)
        yield _drive(mp, tmp, ["--upscale", "--upscale_weights", ckpt])
    finally:
        mp.undo()


def _refuse(*a, **k):
    raise AssertionError("the stage tried to download")


@pytest.fixture(scope="module")
def swin_ckpt(tmp_path_factory):
    return weights.write(SWIN, SEED, "cpu", str(
        tmp_path_factory.mktemp("sw") / "swinir.pth"))


@pytest.fixture(scope="module")
def swin_staged(tmp_path_factory, swin_ckpt):
    """One driver run of 2 SwinIR frames of SW x SH, downloading
    refused."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("swin_staged")
    try:
        mp.setattr(urllib.request, "urlretrieve", _refuse)
        yield _drive(mp, tmp, ["--width", str(SW), "--height", str(SH),
                               "--upscale", "--upscale_weights", swin_ckpt])
    finally:
        mp.undo()


def _reference(raw: np.ndarray, sd: dict, dtype=torch.float32):
    """(u8, float) of the reference on the program's tile grid and
    stitch: each tile a forward, each output pixel from its owner."""
    origins, th, tw = rup.grid(H, W, TILE, OVERLAP)
    own = rup.owner(origins, H, W, th, tw, OVERLAP, 4)
    batch = rup.tiles(rup.to_float(raw), origins, th, tw)
    w = {k: v.to(dtype) for k, v in sd.items()}
    out = np.zeros((4 * H, 4 * W, 3), np.float32)
    with torch.no_grad(), rup.precision(False):
        for t, tile in enumerate(batch):
            x = torch.as_tensor(np.ascontiguousarray(
                tile.transpose(2, 0, 1)))[None].to(dtype)
            y = rup.forward(w, x, 23, 4)[0].float().permute(1, 2, 0).numpy()
            y0, x0 = origins[t]
            m = own[y0 * 4:(y0 + th) * 4, x0 * 4:(x0 + tw) * 4] == t
            m = np.pad(m, ((0, 4 * th - m.shape[0]),
                           (0, 4 * tw - m.shape[1])))
            ys, xs = np.nonzero(m)
            out[y0 * 4 + ys, x0 * 4 + xs] = y[ys, xs]
    u8 = rup.to_u8(torch.from_numpy(out)).numpy()
    return u8, out


def _within(got_u8, want_u8, got_f, want_f) -> bool:
    d = np.abs(got_u8.astype(int) - want_u8.astype(int))
    return bool((d == 0).mean() >= 0.999 and d.max() <= 1
                and np.abs(got_f - want_f).max()
                <= 1e-5 * np.abs(want_f).max())


def _frames(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".png"))


def test_each_frame_is_upscaled_inside_the_loop(staged):
    """Frame i's upscaled PNG, 4x its size, is written after its raw PNG,
    after frame i-1's upscaled PNG, and before the run ends."""
    timer, out, writes = staged
    frames = _frames(out)
    assert frames == ["frame_0000.png", "frame_0001.png"]
    assert _frames(out + "_upscaled") == frames
    raw = [os.path.join(out, f) for f in frames]
    up = [os.path.join(out + "_upscaled", f) for f in frames]
    assert sorted(writes) == sorted(raw + up)
    assert [w for w in writes if w in up] == up
    for r, u in zip(raw, up):
        assert writes.index(r) < writes.index(u)
        assert image_io.read_png(u).shape == (4 * H, 4 * W, 3)
    run_end = next(r[2] for r in timer.records if r[0] == "run")
    assert all(r[2] <= run_end for r in timer.records
               if r[0] == "upscale_encode")


def test_upscaled_frames_match_the_reference(staged, ckpt):
    _, out, _ = staged
    sd = weights.load(ckpt, "cpu")
    net = esrgan.load_torch_checkpoint(ckpt, device="cpu")
    for f in _frames(out):
        raw = image_io.read_png(os.path.join(out, f))
        assert (raw > 0).any(-1).mean() > 0.01          # the station is lit
        got = image_io.read_png(os.path.join(out + "_upscaled", f))
        want_u8, want_f = _reference(raw, sd)
        inside = ((want_u8 > 0) & (want_u8 < 255)).mean()
        assert inside > 0.9 and want_u8.std() > 1.0, (inside, want_u8.std())
        got_f = esrgan.upscale_tiled(net, raw.astype(np.float32) / 255.0,
                                     TILE, OVERLAP)
        assert _within(got, want_u8, got_f, want_f)


def test_the_tolerance_fails_the_reference_in_bfloat16(staged, ckpt):
    _, out, _ = staged
    sd = weights.load(ckpt, "cpu")
    f = _frames(out)[-1]
    raw = image_io.read_png(os.path.join(out, f))
    got = image_io.read_png(os.path.join(out + "_upscaled", f))
    net = esrgan.load_torch_checkpoint(ckpt, device="cpu")
    got_f = esrgan.upscale_tiled(net, raw.astype(np.float32) / 255.0,
                                 TILE, OVERLAP)
    low_u8, low_f = _reference(raw, sd, torch.bfloat16)
    assert not _within(low_u8, got, low_f, got_f)


def test_stage_spans_have_their_frames_and_parents(staged):
    timer, _, _ = staged
    rec = timer.records
    rows = sorted((name, frame, rec[parent][0] if parent >= 0 else None)
                  for name, _, _, frame, parent in rec
                  if name in STAGE_SPANS)
    assert rows == sorted([("upscale_load", -1, "run"),
                           ("upscale", 0, "run"),
                           ("upscale_forward", 0, "upscale"),
                           ("upscale_finish", 0, "run"),
                           ("upscale_encode", 0, "run"),
                           ("upscale", 1, "run"),
                           ("upscale_forward", 1, "upscale"),
                           ("upscale_drain", 1, "run"),
                           ("upscale_encode", 1, "run")])
    at = {(r[0], r[3]): (r[1], r[2]) for r in rec}
    assert at[("upscale_load", -1)][1] <= at[("upscale", 0)][0]
    for i in (0, 1):
        # after the frame's own PNG; the write after the upscale
        assert at[("encode", i)][1] <= at[("upscale", i)][0]
        assert at[("upscale", i)][1] <= at[("upscale_encode", i)][0]
        assert at[("upscale_encode", i)][0] <= at[("upscale_encode", i)][1]
    # frame 0 is finished once frame 1's forward is queued, frame 1 at
    # the end; each write after its frame's finish
    assert at[("upscale", 1)][1] <= at[("upscale_finish", 0)][0]
    assert at[("upscale_finish", 0)][1] <= at[("upscale_encode", 0)][0]
    assert at[("upscale_drain", 1)][1] <= at[("upscale_encode", 1)][0]
    # one write in flight: frame 1's starts once frame 0's is done
    assert at[("upscale_encode", 0)][1] <= at[("upscale_encode", 1)][0]


def _three(monkeypatch, tmp, ckpt, *extra):
    """3 frames of 16x12 through the stage: (timer, output dir, PNG
    writes), and the rows [name, start, end, frame, parent's name] of
    the spans that finish a frame's upscale."""
    os.makedirs(tmp, exist_ok=True)
    timer, out, writes = _drive(monkeypatch, tmp, [
        "--width", "16", "--height", "12", "--upscale",
        "--upscale_weights", ckpt, *extra], n=3)
    rec = timer.records
    done = [r[:4] + [rec[r[4]][0]] for r in rec
            if r[0] in ("upscale_finish", "upscale_drain")]
    return timer, out, writes, done


def _written_in_order(out, writes):
    """Upscaled PNGs written in frame order, each after its raw PNG."""
    frames = _frames(out)
    assert len(frames) == 3 and _frames(out + "_upscaled") == frames
    up = [os.path.join(out + "_upscaled", f) for f in frames]
    assert [w for w in writes if w in up] == up
    for f, u in zip(frames, up):
        assert writes.index(os.path.join(out, f)) < writes.index(u)


def test_each_frame_is_finished_once_the_next_forward_is_queued(
        tmp_path, monkeypatch, ckpt):
    timer, out, writes, done = _three(monkeypatch, tmp_path, ckpt)
    assert [(r[0], r[3], r[4]) for r in done] == [
        ("upscale_finish", 0, "run"), ("upscale_finish", 1, "run"),
        ("upscale_drain", 2, "run")]
    fwd = {r[3]: r[2] for r in timer.records if r[0] == "upscale_forward"}
    for name, t0, _, frame, _ in done[:2]:
        assert fwd[frame + 1] <= t0
    assert fwd[2] <= done[2][1]
    _written_in_order(out, writes)


def test_no_pipeline_drains_each_frame_in_its_own_stage_call(
        tmp_path, monkeypatch, ckpt):
    timer, out, writes, done = _three(monkeypatch, tmp_path / "serial", ckpt,
                                      "--no_pipeline")
    assert [(r[0], r[3], r[4]) for r in done] == [
        ("upscale_drain", i, "run") for i in range(3)]
    up = {r[3]: (r[1], r[2]) for r in timer.records if r[0] == "upscale"}
    for _, t0, t1, frame, _ in done:
        assert up[frame][1] <= t0
        assert frame == 2 or t1 <= up[frame + 1][0]
    _written_in_order(out, writes)
    # the same bytes as the pipelined run's
    _, piped, _, _ = _three(monkeypatch, tmp_path / "piped", ckpt)
    for f in _frames(out + "_upscaled"):
        with open(os.path.join(out + "_upscaled", f), "rb") as a, \
                open(os.path.join(piped + "_upscaled", f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("extra,want", [((), 2 / 3), (("--no_pipeline",), 0.0)],
                         ids=["pipelined", "no_pipeline"])
def test_overlapped_reader_counts_frames_finished_behind_a_forward(
        tmp_path, monkeypatch, ckpt, extra, want):
    """portbench's `upscale.overlapped` on the driver's own spans: the
    `upscale_finish` rows per PNG written."""
    timer, out, _, _ = _three(monkeypatch, tmp_path, ckpt, *extra)
    run = Run()
    run.tsv = [(r[0], (r[2] - r[1]) * 1e-9) for r in timer.records]
    run.frames = [Frame(0, i, "", "", 0.1) for i in range(3)]
    read = Bench().reader("upscale.overlapped")
    assert read(run) == pytest.approx(want)
    run.tsv = [r for r in run.tsv
               if r[0] not in ("upscale_finish", "upscale_drain")]
    assert read(run) is None        # a program without the two spans


def test_no_stage_span_without_upscale(tmp_path, monkeypatch):
    def never(*a, **k):
        raise AssertionError("the network ran without --upscale")
    monkeypatch.setattr(esrgan, "upscale_u8", never)
    monkeypatch.setattr(upsample, "Upscaler", never)
    timer, out, writes = _drive(monkeypatch, tmp_path, [
        "--width", "16", "--height", "12", "--timings_tsv",
        str(tmp_path / "t.tsv")])
    assert not any(r[0] in STAGE_SPANS for r in timer.records)
    assert not any("upscale" in ln for ln in open(tmp_path / "t.tsv"))
    assert not os.path.exists(out + "_upscaled")
    assert writes == [os.path.join(out, f) for f in _frames(out)]


def test_missing_weights_fail_the_run_at_the_first_stage(tmp_path,
                                                         monkeypatch):
    """No download, no lookup, no bicubic: the run fails once the first
    frame's PNG is saved, with nothing in `_upscaled`."""
    tried = []

    def refuse(*a, **k):
        tried.append(a)
        raise OSError("no network")

    def lookup(*a, **k):
        tried.append(a)
        raise AssertionError("the named file was not taken")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(upsample, "fetch_weights", lookup)
    monkeypatch.setattr(upsample, "upsample_torch", lookup)
    monkeypatch.setattr(upsample, "upsample_pil", lookup)
    with pytest.raises(FileNotFoundError):
        _drive(monkeypatch, tmp_path, [
            "--width", "16", "--height", "12", "--upscale",
            "--upscale_weights", str(tmp_path / "missing.pth")])
    out = str(tmp_path / "frames")
    assert _frames(out) == ["frame_0000.png"]
    assert os.listdir(out + "_upscaled") == []
    assert tried == []


def test_resume_skips_frames_whose_upscaled_png_exists(tmp_path, monkeypatch,
                                                       ckpt):
    flags = ["--width", "16", "--height", "12", "--upscale",
             "--upscale_weights", ckpt, "--resume"]
    _, out, first = _drive(monkeypatch, tmp_path, flags)
    assert len(first) == 4
    os.unlink(os.path.join(out + "_upscaled", "frame_0001.png"))
    _, _, again = _drive(monkeypatch, tmp_path, flags)
    assert again == [os.path.join(out, "frame_0001.png"),
                     os.path.join(out + "_upscaled", "frame_0001.png")]


def _u8_within(got, want) -> bool:
    d = np.abs(got.astype(int) - want.astype(int))
    return bool((d == 0).mean() >= 0.999 and d.max() <= 1)


def test_swinir_frames_match_the_reference(swin_staged, swin_ckpt):
    """The driver's SwinIR PNGs against the reference's u8 on the
    program's raw PNG of each frame (one tile, run whole)."""
    _, out, _ = swin_staged
    sd = weights.load(swin_ckpt, "cpu")
    assert _frames(out) == _frames(out + "_upscaled") == [
        "frame_0000.png", "frame_0001.png"]
    for f in _frames(out):
        raw = image_io.read_png(os.path.join(out, f))
        assert raw.any()                               # the station is in
        got = image_io.read_png(os.path.join(out + "_upscaled", f))
        batch = rup.to_float(raw)[None]
        want = rup.upscale_tiles(sd, batch, SWIN, "cpu")[0]
        assert got.shape == want.shape == (4 * SH, 4 * SW, 3)
        assert ((want >= 1) & (want <= 254)).mean() > 0.9
        assert _u8_within(got, want)
        low = rup.upscale_tiles(sd, batch, SWIN, "cpu",
                                dtype=torch.bfloat16)[0]
        assert not _u8_within(low, want)


def test_swinir_spans_have_their_frames_and_parents(swin_staged):
    """Each frame's forward holds its 2 RSTBs (`swin_rstb`, inside
    `upscale_forward`) and each of their 2 layers' attention cores
    (`swin_attn`, inside its RSTB), with the frame's id."""
    timer, _, _ = swin_staged
    rec = timer.records
    rows = sorted((name, frame, rec[parent][0])
                  for name, _, _, frame, parent in rec if name in SWIN_SPANS)
    assert rows == sorted(
        [("swin_rstb", i, "upscale_forward") for i in (0, 1)] * 2
        + [("swin_attn", i, "swin_rstb") for i in (0, 1)] * 4)
    for name, t0, t1, _, parent in rec:
        if name in SWIN_SPANS:
            assert rec[parent][1] <= t0 <= t1 <= rec[parent][2]


def test_rrdbnet_run_has_no_swin_spans(staged):
    timer, _, _ = staged
    assert not any(r[0] in SWIN_SPANS for r in timer.records)
    assert any(r[0] == "upscale_forward" for r in timer.records)
