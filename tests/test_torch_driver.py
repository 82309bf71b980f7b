"""The port's frame-loop driver (python -m dsrt_tpu_torch.driver) against
the reference driver's parity mode on the same orbit-simulator poses.

Both sides use --standin_detail 3 (3,604 triangles, above the reference's
LANE_SWITCH_TRIS, so its parity renderer walks per ray like the port).
Image rule as in test_torch_render: u8-exact expected; at least 99% of
pixels identical and mean |d| <= 0.5 u8 allowed for XLA-CPU's cos/sin/pow
lowerings and fused multiply-adds.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dsrt_tpu.orbit import cli as orbit_cli
from dsrt_tpu.utils.image_io import read_png
from dsrt_tpu_torch import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--width", "48", "--height", "36", "--spp", "2",
          "--standin_detail", "3"]


def _poses(tmp_path):
    """Two close-range rendezvous poses (54 m and 36 m from the station)."""
    path = str(tmp_path / "poses.txt")
    assert orbit_cli.main(["--time", "0.03", "--dt", "0.01",
                           "--txt", path]) == 0
    return path


def test_driver_matches_reference_parity_frames(tmp_path):
    poses = _poses(tmp_path)
    port_out, ref_out = tmp_path / "port", tmp_path / "ref"
    assert driver.main(["--input_txt", poses, "--output_dir", str(port_out),
                        "--device", "cpu", *COMMON]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "dsrt_tpu.driver", "--mode", "parity",
         "--input_txt", poses, "--output_dir", str(ref_out), *COMMON],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    frames = sorted(os.listdir(port_out))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    assert sorted(os.listdir(ref_out)) == frames
    lit = 0.0
    for f in frames:
        got = read_png(str(port_out / f))
        want = read_png(str(ref_out / f))
        assert got.shape == want.shape == (36, 48, 3)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (diff.max(axis=-1) == 0).mean() >= 0.99, f
        assert diff.mean() <= 0.5, f
        lit = max(lit, (got > 0).mean())
    assert lit > 0.01, "station not lit in either frame"


def test_driver_resume_and_ppm(tmp_path):
    poses = _poses(tmp_path)
    out = tmp_path / "out"
    args = ["--input_txt", poses, "--output_dir", str(out), "--device",
            "cpu", "--width", "16", "--height", "12", "--spp", "1",
            "--max_depth", "3", "--standin_detail", "1"]
    assert driver.main(args + ["--save_ppm", "--timings_tsv",
                               str(tmp_path / "t.tsv")]) == 0
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0000.ppm",
                                       "frame_0001.png", "frame_0001.ppm"]
    assert (tmp_path / "t.tsv").read_text().startswith("stage\t")
    png = out / "frame_0000.png"
    mtime = png.stat().st_mtime_ns
    assert driver.main(args + ["--resume", "--start_frame", "1"]) == 0
    assert png.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("flag", ["--mode", "--shard", "--adaptive",
                                  "--env_map", "--smooth", "--upscale"])
def test_driver_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        driver.build_parser().parse_args([flag, "1"])
