"""The port's super-resolution post-process (python -m
dsrt_tpu_torch.scripts.upsample, and the driver's --upscale) against the
root scripts/upsample.py on the CPU.

The release weights are not in the repository: the RRDBNet checks use a
seeded full-width x4 checkpoint (RRDBNet-23, basicsr keys under
`params_ema`, weights x5 with N(0, 0.05) biases) cached under a HOME of
the test's own, and every test that could reach `fetch_weights`'s
download has `urllib.request.urlretrieve` raise, so no test touches the
network.

Tolerances: the bicubic and PIL backends' PNG bytes identical; the
RRDBNet's u8 >= 99.9% identical to the JAX network's, max |d| <= 1.  Each
test first requires >= 25% of its u8 outputs strictly inside (0, 255).
"""

import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.models.esrgan import state_dict_from_params
from dsrt_tpu_torch.scripts import upsample
from dsrt_tpu_torch.utils.image_io import read_png, write_png
from test_torch_esrgan import FULL, seeded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(".cache", "realesrgan", "RealESRGAN_x4plus.pth")


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A HOME whose weight cache holds a seeded x4 checkpoint."""
    h = tmp_path_factory.mktemp("home")
    os.makedirs(os.path.dirname(h / WEIGHTS))
    torch.save({"params_ema": state_dict_from_params(seeded(0, 4, FULL)[0])},
               str(h / WEIGHTS))
    return h


@pytest.fixture
def offline(monkeypatch):
    def refuse(*a, **k):
        raise OSError("network disabled in tests")
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _frames(d, n=2, w=24, h=20, seed=0):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(str(d / f"frame_{i:04d}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(d)


def _pngs(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _require_in_range(d):
    """>= 25% of the u8 values of the PNGs in `d` inside (0, 255)."""
    for f in sorted(os.listdir(d)):
        u8 = read_png(os.path.join(d, f))
        inside = float(((u8 > 0) & (u8 < 255)).mean())
        assert inside >= 0.25, (f, inside)


def test_torch_backend_bytes_equal_the_root_script(tmp_path):
    from scripts.upsample import process_folder
    src = _frames(tmp_path / "in")
    assert process_folder(src, str(tmp_path / "root"), scale=2,
                          backend="torch") == 2
    assert upsample.process_folder(src, str(tmp_path / "port"), scale=2,
                                   backend="torch", device="cpu") == 2
    _require_in_range(tmp_path / "root")
    root, port = _pngs(tmp_path / "root"), _pngs(tmp_path / "port")
    assert len(port) == 2 and port == root
    assert read_png(str(tmp_path / "port" / "frame_0000.png")).shape == \
        (40, 48, 3)


def test_pil_backend_bytes_equal_the_root_script(tmp_path):
    pytest.importorskip("PIL")
    from scripts.upsample import process_folder
    src = _frames(tmp_path / "in", n=1)
    process_folder(src, str(tmp_path / "root"), scale=4, backend="pil")
    _require_in_range(tmp_path / "root")
    upsample.main(["--in", src, "--out", str(tmp_path / "port"),
                   "--backend", "pil"])
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "root")


def test_rrdbnet_backend_matches_the_root_scripts_jax_backend(
        tmp_path, monkeypatch, home, offline, capsys):
    from scripts.upsample import process_folder
    monkeypatch.setenv("HOME", str(home))
    src = _frames(tmp_path / "in")
    process_folder(src, str(tmp_path / "root"), scale=4, backend="jax")
    assert "via jax" in capsys.readouterr().out
    _require_in_range(tmp_path / "root")
    upsample.main(["--in", src, "--out", str(tmp_path / "port"),
                   "--device", "cpu"])
    assert "via rrdbnet" in capsys.readouterr().out
    for f in ("frame_0000.png", "frame_0001.png"):
        want = read_png(str(tmp_path / "root" / f))
        got = read_png(str(tmp_path / "port" / f))
        assert got.shape == want.shape == (80, 96, 3)
        d = np.abs(got.astype(int) - want.astype(int))
        assert (d == 0).mean() >= 0.999 and d.max() <= 1


def test_auto_without_weights_takes_bicubic_and_says_so(
        tmp_path, monkeypatch, offline, capsys):
    monkeypatch.setenv("HOME", str(tmp_path / "empty_home"))
    src = _frames(tmp_path / "in", n=1)
    assert upsample.process_folder(src, str(tmp_path / "auto"), scale=4,
                                   device="cpu") == 1
    _require_in_range(tmp_path / "auto")
    out = capsys.readouterr()
    assert "falling back to torch bicubic" in out.err
    assert "via torch" in out.out
    upsample.process_folder(src, str(tmp_path / "bicubic"), scale=4,
                            backend="torch", device="cpu")
    assert _pngs(tmp_path / "auto") == _pngs(tmp_path / "bicubic")


def test_rrdbnet_without_weights_raises(tmp_path, monkeypatch, offline):
    monkeypatch.setenv("HOME", str(tmp_path / "empty_home"))
    src = _frames(tmp_path / "in", n=1)
    with pytest.raises(FileNotFoundError, match="download failed"):
        upsample.process_folder(src, str(tmp_path / "out"), scale=4,
                                backend="rrdbnet", device="cpu")


def test_the_upsampler_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _frames(tmp_path / "in", n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        upsample.process_folder(src, str(tmp_path / "out"), scale=4,
                                backend="torch")


def _poses(path):
    from dsrt_tpu_torch.orbit import cli
    assert cli.main(["--time", "0.03", "--dt", "0.01", "--device", "cpu",
                     "--txt", path]) == 0


def test_driver_upscale_writes_4x_frames(tmp_path, monkeypatch, home,
                                         offline, capsys):
    monkeypatch.setenv("HOME", str(home))
    poses = str(tmp_path / "poses.txt")
    _poses(poses)
    out = str(tmp_path / "frames")
    assert driver.main(["--input_txt", poses, "--output_dir", out,
                        "--width", "32", "--height", "18", "--spp", "1",
                        "--max_depth", "3", "--standin_detail", "1",
                        "--device", "cpu", "--upscale"]) == 0
    assert "via rrdbnet" in capsys.readouterr().out
    _require_in_range(out + "_upscaled")
    frames = sorted(os.listdir(out))
    assert len(frames) == 2 and sorted(os.listdir(out + "_upscaled")) == \
        frames
    for f in frames:
        up = read_png(os.path.join(out + "_upscaled", f))
        assert up.shape == (72, 128, 3)


def test_driver_without_upscale_says_so(tmp_path, capsys):
    out = str(tmp_path / "frames")
    assert driver.main(["--output_dir", out, "--width", "8", "--height",
                        "6", "--spp", "1", "--max_depth", "2",
                        "--standin_detail", "1", "--device", "cpu"]) == 0
    assert "Upscaling disabled (use --upscale to enable)." in \
        capsys.readouterr().out
    assert not os.path.exists(out + "_upscaled")


def test_driver_exits_nonzero_on_a_corrupt_checkpoint(tmp_path):
    bad_home = tmp_path / "home"
    os.makedirs(os.path.dirname(bad_home / WEIGHTS))
    (bad_home / WEIGHTS).write_bytes(b"not a checkpoint" * 64)
    env = dict(os.environ, HOME=str(bad_home), PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "dsrt_tpu_torch.driver", "--output_dir",
         str(tmp_path / "frames"), "--width", "8", "--height", "6", "--spp",
         "1", "--max_depth", "2", "--standin_detail", "1", "--device", "cpu",
         "--upscale"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "Saved" in proc.stdout and "Traceback" in proc.stderr
    assert not os.listdir(tmp_path / "frames_upscaled")
