"""The benchmark's frozen inputs against the program's originals."""

import numpy as np
import pytest

from dsrt_tpu_torch.models.mesh_gen import iss_standin_mesh
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.utils.pose import parse_pose_lines
from dsrt_tpu_torch.utils.transform import pose_to_frame
from portbench import poses, reference, standin
from portbench.registry import Bench

TEX = str(Bench().data("data/iss_standin.png"))


def test_pose_generator_reproduces_the_data_file():
    text = poses.pose_text(*poses.polar_rendezvous())
    with open(Bench().data("data/poses99.txt")) as fh:
        assert fh.read() == text
    assert len(poses.read_pose_lines(str(Bench().data("data/poses99.txt")))) == 99


def test_pose_file_matches_the_program_orbit_cli(tmp_path):
    from dsrt_tpu_torch.orbit.cli import main
    out = tmp_path / "p.txt"
    main(["--time", "1", "--dt", "0.01", "--txt", str(out), "--device", "cpu"])
    ours = np.loadtxt(Bench().data("data/poses99.txt"))
    theirs = np.loadtxt(out)
    assert ours.shape == theirs.shape == (99, 9)
    assert np.abs(ours - theirs).max() <= 1e-3


@pytest.mark.parametrize("detail", [1, 12])
def test_standin_mesh_equals_the_program_generator(detail):
    ours = standin.standin_mesh(detail, TEX)
    theirs = iss_standin_mesh(detail, tex_path=TEX)
    for k in ("v0", "v1", "v2", "uv0", "uv1", "uv2"):
        a, b = getattr(ours, k), getattr(theirs, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), k
    assert ours.tex_paths == list(theirs.tex_paths)
    for m, p in zip(ours.materials, theirs.materials):
        assert m.kind == p.kind and tuple(m.albedo) == tuple(p.albedo)
        assert m.fuzz == p.fuzz
    # one benchmark material where the program has one
    pairs = {(id(m), id(p)) for m, p in zip(ours.materials, theirs.materials)}
    assert len(pairs) == len({id(m) for m in ours.materials}) \
        == len({id(p) for p in theirs.materials})


@pytest.mark.parametrize("k", [0, 49, 93, 98])
def test_frame_transform_and_camera_equal_the_program(k):
    line = poses.read_pose_lines(str(Bench().data("data/poses99.txt")))[k]
    cam, sun, sep = poses.frame_of(line)
    fr = pose_to_frame(parse_pose_lines([line])[0])
    assert np.array_equal(cam, fr.cam_in_model)
    assert np.array_equal(sun, fr.sun_dir_model)
    assert sep == fr.separation_m
    c = point_camera_at(fr.cam_in_model, (0.0, 0.0, 0.0), vfov=40.0,
                        width=1920, height=1080, device="cpu")
    o, ll, hz, vt = reference.camera(cam, 40.0, 1920, 1080)
    for a, b in ((o, c.origin), (ll, c.lower_left), (hz, c.horizontal),
                 (vt, c.vertical)):
        assert np.array_equal(a, b.numpy())


def test_texture_decodes_as_the_program_reads_it():
    from dsrt_tpu_torch.utils.image_io import read_png
    from portbench import pngio
    assert np.array_equal(pngio.read_rgb8(TEX), read_png(TEX))
