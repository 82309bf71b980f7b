"""The rendezvous sequence of docs/RUN_RENDEZVOUS.md through the port on
the CPU, against the JAX package.

The port's orbit CLI writes the sequence's 99 poses (`--time 1 --dt
0.01`), within 1e-3 m of the JAX CLI's (as tests/test_torch_orbit.py
holds them).  Poses 0, 49 and 98 (1787, 911 and 36 m from the station)
then go through the port's driver in fused mode (the plain version of
the path kernel on the CPU) and through the JAX driver in parity mode,
on the detail-2 stand-in textured with misc/iss_standin.png, at 48x27,
4 spp, depth 8: the far poses with a 1.5 degree field of view, so that
the station covers lit pixels there, and pose 98 with the driver's 40.
Image rule over the pixels lit in either frame (a frame that is mostly
black says little over all its pixels): each frame has lit pixels; at
most 1% of them, or one, differ from JAX's (XLA-CPU lowers cos, sin and
pow and fuses multiply-adds, so a sample can take another branch); and
at each that differs the port's u8 equals the NumPy oracle's
(dsrt_tpu/oracle.py), computed for that pixel alone.  So the port is
u8-exact at every lit pixel against JAX or, where JAX strays, the oracle.
The port's driver log and timings TSV go through tools/sequence_stats.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from dsrt_tpu import driver as jax_driver
from dsrt_tpu.ops.camera import point_camera_at as jax_point_camera_at
from dsrt_tpu.oracle import F, LCG, OracleScene, ray_color
from dsrt_tpu.orbit import cli as jax_cli
from dsrt_tpu.utils.pose import read_pose_file as jax_read_pose_file
from dsrt_tpu.utils.timing import StageTimer
from dsrt_tpu.utils.transform import pose_to_frame as jax_pose_to_frame
from dsrt_tpu_torch import driver
from dsrt_tpu_torch.orbit import cli
from dsrt_tpu_torch.tools.sequence_stats import sequence_stats
from dsrt_tpu_torch.utils.image_io import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = ["--time", "1", "--dt", "0.01"]
# (poses, field of view [degrees]) of the two runs
RUNS = (((0, 49), "1.5"), ((98,), "40"))
FRAME = ["--width", "48", "--height", "27", "--spp", "4", "--max_depth",
         "8", "--standin_detail", "2", "--standin_tex",
         os.path.join(ROOT, "misc", "iss_standin.png")]
MIN_LIT = 10
STRAY = 0.01


def _pose_lines(path):
    with open(path) as fh:
        return [ln for ln in fh if ln.strip() and not ln.startswith("#")]


def oracle_pixel(sc, cam, cfg, row: int, x: int) -> np.ndarray:
    """u8 of pixel (row from the top, x) of dsrt_tpu.oracle.render_oracle
    on the OracleScene `sc`: its loop body for that pixel alone (no lens,
    no shutter)."""
    assert cfg.aperture == 0 and cfg.time1 <= cfg.time0
    W, H = cfg.width, cfg.height
    y = H - 1 - row
    spp = max(1, cfg.spp)
    origin, ll, hz, vt = (np.asarray(v, F) for v in (
        cam.origin, cam.lower_left, cam.horizontal, cam.vertical))
    rng = LCG(np.uint32(x + y * W) ^ np.uint32(sc.seed & 0xFFFFFFFF))
    accum = np.zeros(3, F)
    for s in range(spp):
        jx = (F(s) + rng.rand()) / F(spp)
        jy = (F(s) + rng.rand()) / F(spp)
        u = (F(x) + jx) / F(W - 1)
        v = (F(y) + jy) / F(H - 1)
        rd = (ll + u * hz + v * vt - origin).astype(F)
        accum += ray_color(sc, origin, rd, rng, cfg.max_depth,
                           cfg.rr_start_depth, cfg.rr_max_p)
    c = np.clip(accum / F(spp), 0.0, None)
    c = np.minimum(c, cfg.firefly_clamp)
    c = np.clip(np.power(c, F(1.0 / cfg.gamma)), 0.0, 1.0)
    return (F(255.99) * c).astype(np.uint8)


def _oracle_inputs(txt, frame):
    """(OracleScene, camera, config) of each pose of `txt` as the JAX
    driver renders it with the flags `frame`."""
    args = jax_driver.build_parser().parse_args(frame)
    with contextlib.redirect_stdout(sys.stderr):
        scene = jax_driver.build_scene(args, StageTimer())
    cfg = jax_driver.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.max_depth, vfov=args.vfov, gamma=args.gamma,
        seed=args.seed, sky_type=args.sky)
    out = []
    for pose in jax_read_pose_file(txt):
        f = jax_pose_to_frame(pose)
        sc = OracleScene(dataclasses.replace(
            scene, sun_dir=np.asarray(f.sun_dir_model, np.float32)))
        cam = jax_point_camera_at(f.cam_in_model, (0.0, 0.0, 0.0),
                                  vfov=args.vfov, width=args.width,
                                  height=args.height)
        out.append((sc, cam, cfg))
    return out


def _frames(tmp_path, capsys, lines, poses, vfov):
    """The port's fused driver and JAX's parity driver over `poses` of
    `lines`: [(port u8, JAX u8, the oracle's inputs)] and
    tools/sequence_stats of the port's run."""
    txt = str(tmp_path / f"poses_{vfov}.txt")
    with open(txt, "w") as fh:
        fh.writelines(lines[i] for i in poses)
    port_out, ref_out = tmp_path / f"port_{vfov}", tmp_path / f"ref_{vfov}"
    tsv = str(tmp_path / f"timings_{vfov}.tsv")
    frame = FRAME + ["--vfov", vfov]
    capsys.readouterr()
    assert driver.main(["--input_txt", txt, "--output_dir", str(port_out),
                        "--device", "cpu", "--mode", "fused",
                        "--timings_tsv", tsv, *frame]) == 0
    stats = sequence_stats(capsys.readouterr().out, tsv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "dsrt_tpu.driver", "--mode", "parity",
         "--input_txt", txt, "--output_dir", str(ref_out), *frame],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = [f"frame_{i:04d}.png" for i in range(len(poses))]
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(ref_out)) \
        == names
    return [(read_png(str(port_out / f)), read_png(str(ref_out / f)), o)
            for f, o in zip(names, _oracle_inputs(txt, frame))], stats


def test_rendezvous_poses_and_frames_match_jax(tmp_path, capsys):
    port_txt, jax_txt = str(tmp_path / "poses99.txt"), str(tmp_path / "j.txt")
    assert cli.main(SPAN + ["--device", "cpu", "--txt", port_txt]) == 0
    assert jax_cli.main(SPAN + ["--txt", jax_txt]) == 0
    port, ref = np.loadtxt(port_txt), np.loadtxt(jax_txt)
    assert port.shape == ref.shape == (99, 9)
    assert np.abs(port - ref).max() <= 1e-3

    lines = _pose_lines(port_txt)
    frames, seps = [], []
    for poses, vfov in RUNS:
        pairs, stats = _frames(tmp_path, capsys, lines, poses, vfov)
        assert [f["index"] for f in stats["frames"]] == list(
            range(len(poses)))
        assert {f["label"] for f in stats["frames"]} == {"fused on cpu"}
        assert stats["rays"] == sum(f["rays"] for f in stats["frames"]) > 0
        assert stats["loop_wall_s"] > 0
        frames += pairs
        seps += [f["separation_m"] for f in stats["frames"]]
    assert seps[0] > 1780 and 900 < seps[1] < 920 and seps[2] < 40
    for k, (got, want, oracle) in enumerate(frames):
        assert got.shape == want.shape == (27, 48, 3)
        lit = (got.max(axis=-1) > 0) | (want.max(axis=-1) > 0)
        assert lit.sum() >= MIN_LIT, k
        differ = np.argwhere(lit & (got != want).any(axis=-1))
        assert len(differ) <= max(1, STRAY * lit.sum()), k
        for row, x in differ:
            np.testing.assert_array_equal(
                got[row, x], oracle_pixel(*oracle, row, x),
                err_msg=f"frame {k} pixel ({row}, {x})")


def test_frame_inputs_reproduce_the_drivers_frame(tmp_path, capsys):
    """driver.frame_inputs and driver.render_config give the scene,
    camera and config the frame loop renders: the same PNG."""
    import torch

    from dsrt_tpu_torch.render import render_frame_fused
    from dsrt_tpu_torch.utils.pose import default_pose
    from dsrt_tpu_torch.utils.timing import StageTimer as PortTimer
    from dsrt_tpu_torch.utils.transform import pose_to_frame
    argv = ["--width", "24", "--height", "14", "--spp", "2", "--max_depth",
            "4", "--standin_detail", "1", "--device", "cpu"]
    out = tmp_path / "frames"
    assert driver.main(argv + ["--output_dir", str(out)]) == 0
    args = driver.build_parser().parse_args(argv)
    dev = torch.device("cpu")
    with contextlib.redirect_stdout(sys.stderr):
        scene = driver.build_scene(args, PortTimer(), dev)
    s, cam = driver.frame_inputs(args, scene, pose_to_frame(default_pose()),
                                 dev)
    img = render_frame_fused(s, cam, driver.render_config(args))
    np.testing.assert_array_equal(img, read_png(str(out / "frame_0000.png")))
    assert (img > 0).any()


def test_sequence_stats_of_a_log(tmp_path):
    """Frame lines in the order the frames finished (frame 5 finished at
    once, between pipelined ones), the loop wall to the ms, and a TSV
    that does not match the log."""
    log = "\n".join([
        "=== Frame 3 ===", "  sep(cam, model) = 100.500 m",
        "=== Frame 4 ===", "  sep(cam, model) = 50.250 m",
        "  [frame 3] render (fused on cuda) + wait: 20 ms, 50.0 Mrays/s, "
        "1000000 rays exact",
        "=== Frame 5 ===", "  sep(cam, model) = 25.000 m",
        "  [frame 5] render (fused on cuda) + wait: 40 ms, 75.0 Mrays/s, "
        "3000000 rays exact",
        "  [frame 4] render (fused on cuda) + wait: 10 ms, 200.0 Mrays/s, "
        "2000000 rays exact", "", "Total runtime: 0.123 s (3 frames)"])
    tsv = tmp_path / "t.tsv"
    tsv.write_text("stage\tduration_ns\tindex\nscene_compile\t5\t0\n"
                   "render\t20000000\t1\nencode\t1000000\t2\n"
                   "render\t40000000\t3\nrender\t10000000\t4\n"
                   "encode\t2000000\t5\n")
    st = sequence_stats(log, str(tsv))
    assert [(f["index"], f["separation_m"], f["rays"]) for f in st["frames"]] \
        == [(3, 100.5, 1000000), (5, 25.0, 3000000), (4, 50.25, 2000000)]
    assert st["loop_wall_s"] == 0.123 and st["rays"] == 6000000
    assert st["sustained_mrays_per_s"] == 6000000 / 0.123 / 1e6
    assert st["slowest"] == dict(index=5, separation_m=25.0, render_s=0.04)
    assert st["render_s"]["median"] == 0.02
    assert abs(st["encode_s"] - 0.003) < 1e-12
    tsv.write_text("stage\tduration_ns\tindex\nrender\t1\t0\n")
    with pytest.raises(ValueError):
        sequence_stats(log, str(tsv))
