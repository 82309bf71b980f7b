"""The port's frame loop on the CPU (python -m dsrt_tpu_torch.driver
--device cpu): the pipelined loop (`render_frame_async` one frame ahead
of the encode) against --no_pipeline, and the flags of the adaptive,
debug and budgeted frames, each against the entry point it drives.

Tolerance: PNG bytes identical.
"""

import os

import numpy as np
import pytest

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.render import (finish, render_frame_async,
                                   render_frame_fused)
from dsrt_tpu_torch.utils.image_io import read_png
from dsrt_tpu_torch.utils.pose import write_pose_file

COMMON = ["--width", "24", "--height", "16", "--spp", "4", "--max_depth",
          "4", "--standin_detail", "1", "--device", "cpu"]
# three poses about the stand-in, the Sun at the world origin
CAMS = np.array([[-20.0, -30.0, -95.0], [40.0, 60.0, 190.0],
                 [-60.0, 20.0, 150.0]])


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("poses") / "poses.txt")
    model = np.array([1.0e9, 1.5e9, 2.0e9])
    write_pose_file(path, model + CAMS, np.stack([model] * 3), yaw=0.0)
    return path


def _run(poses, out, *extra):
    assert driver.main(["--input_txt", poses, "--output_dir", str(out),
                        *COMMON, *extra]) == 0
    names = sorted(os.listdir(out))
    return {n: (out / n).read_bytes() for n in names if n.endswith(".png")}


@pytest.mark.parametrize("mode", ["fused", "wavefront"])
def test_pipelined_frames_equal_serial_frames(poses, tmp_path, capsys, mode):
    piped = _run(poses, tmp_path / "piped", "--mode", mode)
    serial = _run(poses, tmp_path / "serial", "--mode", mode, "--no_pipeline")
    assert len(piped) == 3 and piped == serial
    log = capsys.readouterr().out
    # both loops issue each frame with render_frame_async and wait on it
    assert log.count(f"render ({mode} on cpu) + wait") == 6
    assert max((read_png(str(tmp_path / "piped" / n)) > 0).mean()
               for n in piped) > 0.05


def test_async_frame_is_the_fused_frame():
    from dsrt_tpu_torch.models.presets import rtiow_smoke_scene
    from dsrt_tpu_torch.ops.camera import make_camera
    scene = rtiow_smoke_scene(device="cpu")
    cfg = RenderConfig(width=16, height=8, spp=2, max_depth=4)
    cam = make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=50, width=16,
                      height=8, device="cpu")
    frame = render_frame_async(scene, cam, cfg)
    assert frame.done is None   # a CPU frame is complete
    img, nrays = finish(frame)
    want, want_rays = render_frame_fused(scene, cam, cfg, with_count=True)
    np.testing.assert_array_equal(img, want)
    assert nrays == want_rays
    with pytest.raises(ValueError):
        render_frame_async(scene, cam, cfg, mode="queue")


def test_adaptive_debug_budget_and_profile_flags(poses, tmp_path, capsys):
    adaptive = _run(poses, tmp_path / "adaptive", "--adaptive", "0.05",
                    "--adaptive_chunk", "2")
    assert "adaptive: mean spp" in capsys.readouterr().out
    solid = _run(poses, tmp_path / "solid", "--debug_shade")
    gradient = _run(poses, tmp_path / "gradient", "--debug_shade", "--sky",
                    "gradient")
    assert len(adaptive) == len(solid) == len(gradient) == 3
    assert solid != gradient
    for d, frames in (("adaptive", adaptive), ("solid", solid),
                      ("gradient", gradient)):
        imgs = [read_png(str(tmp_path / d / n)) for n in frames]
        assert all(img.shape == (16, 24, 3) for img in imgs)
        assert max((img > 0).mean() for img in imgs) > 0.05, d
    # a budget of one sample a launch: four salted chunks, other pixels
    # than the one-launch frame's
    one = _run(poses, tmp_path / "one", "--mode", "fused")
    chunked = _run(poses, tmp_path / "chunked", "--mode", "fused",
                   "--dispatch_rays", str(24 * 16))
    unchunked = _run(poses, tmp_path / "unchunked", "--mode", "fused",
                     "--dispatch_rays", "0")
    assert chunked != one and unchunked == one
    _run(poses, tmp_path / "profiled", "--mode", "fused", "--profile",
         str(tmp_path / "trace"))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_adaptive_on_a_scene_no_kernel_covers_raises(poses, tmp_path):
    b = SceneBuilder(sun_enabled=True, seed=1337)
    for i in range(17):
        b.add_sphere((0.1 * i, 0.0, 0.0), 0.05, Material.lambertian())
    scene = b.build(device="cpu")
    args = driver.build_parser().parse_args(
        ["--input_txt", poses, "--output_dir", str(tmp_path), *COMMON,
         "--adaptive", "0.02"])
    with pytest.raises(ValueError):
        driver.run(args, scene=scene)
