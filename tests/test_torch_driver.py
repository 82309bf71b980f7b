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


@pytest.mark.parametrize("flag", ["--mode", "--shard", "--shard_sp",
                                  "--hosts", "--host_id", "--block_h",
                                  "--pallas", "--pops", "--sun_pops"])
def test_driver_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        driver.build_parser().parse_args([flag, "1"])


@pytest.mark.parametrize("flag", driver.TPU_FLAGS)
def test_driver_names_the_migration_guide_for_tpu_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main([flag, "2", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "docs/MIGRATION.md" in err


def test_driver_timings_parse_with_the_performance_script(tmp_path):
    from scripts.performance import read_tsv
    tsv = tmp_path / "t.tsv"
    assert driver.main(["--input_txt", _poses(tmp_path), "--output_dir",
                        str(tmp_path / "out"), "--device", "cpu", "--width",
                        "16", "--height", "12", "--spp", "1", "--max_depth",
                        "3", "--standin_detail", "1", "--timings_tsv",
                        str(tsv)]) == 0
    stages = read_tsv(str(tsv))
    assert {"mesh_load", "scene_compile", "render", "encode"} <= set(stages)
    assert len(stages["render"]) == len(stages["encode"]) == 2
    assert all(ms >= 0 for ds in stages.values() for ms in ds)


def _write_smooth_obj(path):
    """A faceted sphere of radius 20 at the origin with its vertex normals
    (v / vn / f lines), the smooth mesh of models/feature_scenes.py."""
    from dsrt_tpu_torch.models.feature_scenes import uv_sphere_mesh
    from dsrt_tpu_torch.models.materials import Material
    m = uv_sphere_mesh(Material, (0.0, 0.0, 0.0), 20.0)
    lines = []
    for i in range(len(m.v0)):
        for v in (m.v0[i], m.v1[i], m.v2[i]):
            lines.append("v %.9g %.9g %.9g" % tuple(v))
        for n in (m.n0[i], m.n1[i], m.n2[i]):
            lines.append("vn %.9g %.9g %.9g" % tuple(n))
        k = 3 * i
        lines.append(f"f {k + 1}//{k + 1} {k + 2}//{k + 2} {k + 3}//{k + 3}")
    path.write_text("\n".join(lines) + "\n")


def _driver_pair(tmp_path, extra):
    """Frames of the port's driver (--device cpu) and of the reference
    driver's parity mode with the same flags."""
    poses = _poses(tmp_path)
    port_out, ref_out = tmp_path / "port", tmp_path / "ref"
    assert driver.main(["--input_txt", poses, "--output_dir", str(port_out),
                        "--device", "cpu", *COMMON, *extra]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "dsrt_tpu.driver", "--mode", "parity",
         "--input_txt", poses, "--output_dir", str(ref_out), *COMMON,
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    frames = sorted(os.listdir(port_out))
    assert frames == sorted(os.listdir(ref_out)) and len(frames) == 2
    return [(read_png(str(port_out / f)), read_png(str(ref_out / f)))
            for f in frames]


def _assert_frames_match(pairs):
    for got, want in pairs:
        assert got.shape == want.shape == (36, 48, 3)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert (diff.max(axis=-1) == 0).mean() >= 0.99
        assert diff.mean() <= 0.5


def test_driver_env_map_matches_reference(tmp_path):
    """--env_map / --env_rotation / --env_scale: the sky fills the frame
    around the station, as in the reference driver."""
    from dsrt_tpu_torch.models.feature_scenes import env_array
    from dsrt_tpu_torch.utils.image_io import write_png
    sky = str(tmp_path / "sky.png")
    write_png(sky, (np.clip(env_array(), 0.0, 1.0) * 255).astype(np.uint8))
    pairs = _driver_pair(tmp_path, ["--env_map", sky, "--env_rotation", "30",
                                    "--env_scale", "1.5"])
    _assert_frames_match(pairs)
    assert min((got > 0).all(-1).mean() for got, _ in pairs) > 0.5


def test_driver_smooth_obj_matches_reference(tmp_path):
    """--obj with --smooth: the OBJ's vn normals shade the mesh, as in
    the reference driver; without --smooth the frame differs."""
    obj = tmp_path / "ball.obj"
    _write_smooth_obj(obj)
    pairs = _driver_pair(tmp_path, ["--obj", str(obj), "--smooth"])
    _assert_frames_match(pairs)
    flat = tmp_path / "flat"
    assert driver.main(["--input_txt", str(tmp_path / "poses.txt"),
                        "--output_dir", str(flat), "--device", "cpu",
                        *COMMON, "--obj", str(obj)]) == 0
    got = read_png(str(flat / "frame_0000.png"))
    assert (got > 0).mean() > 0.05
    assert (got != pairs[0][0]).any()
