"""The port driver's --shard, --shard_sp, --hosts and --host_id on the CPU.

--shard runs on two ranks that torch.multiprocessing.spawn starts (gloo,
one thread a rank), each calling `driver.main` as a torch.distributed.run
rank would.  Tolerance: PNG bytes identical to the unsharded driver's.
"""

import os

import numpy as np
import pytest
import torch

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.parallel.mesh import spawn_ranks
from dsrt_tpu_torch.utils.pose import write_pose_file

COMMON = ["--width", "48", "--height", "32", "--spp", "4", "--max_depth",
          "4", "--standin_detail", "1", "--device", "cpu"]
# three poses about the stand-in, the Sun at the world origin
CAMS = np.array([[-20.0, -30.0, -95.0], [40.0, 60.0, 190.0],
                 [-60.0, 20.0, 150.0]])
RANKS_TIMEOUT = 180     # seconds for two ranks' three frames


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("poses") / "poses.txt")
    model = np.array([1.0e9, 1.5e9, 2.0e9])
    write_pose_file(path, model + CAMS, np.stack([model] * 3), yaw=0.0)
    return path


def argv(poses, out, *extra):
    return ["--input_txt", poses, "--output_dir", str(out), *COMMON, *extra]


def pngs(out):
    return {n: (out / n).read_bytes() for n in sorted(os.listdir(out))
            if n.endswith(".png")}


@pytest.fixture(scope="module")
def unsharded(poses, tmp_path_factory):
    out = tmp_path_factory.mktemp("unsharded")
    assert driver.main(argv(poses, out)) == 0
    return pngs(out)


def test_hosts_split_the_frames(poses, unsharded, tmp_path):
    parts = []
    for host in (0, 1):
        out = tmp_path / f"host{host}"
        assert driver.main(argv(poses, out, "--hosts", "2", "--host_id",
                                str(host))) == 0
        parts.append(pngs(out))
    assert sorted(parts[0]) == ["frame_0000.png", "frame_0002.png"]
    assert sorted(parts[1]) == ["frame_0001.png"]
    assert {**parts[0], **parts[1]} == unsharded


def test_host_id_outside_hosts_is_refused(poses, tmp_path):
    with pytest.raises(SystemExit):
        driver.main(argv(poses, tmp_path, "--hosts", "2", "--host_id", "2"))


def test_sharded_driver_frames_equal_unsharded(poses, unsharded, tmp_path,
                                               capfd):
    out = tmp_path / "sharded"
    spawn_ranks(driver.main, 2, argv(poses, out, "--shard", "--save_ppm"),
                threads=1, timeout=RANKS_TIMEOUT)
    assert pngs(out) == unsharded
    log = capfd.readouterr().out
    # rank 0 alone prints the frame lines and writes
    assert log.count("=== Frame") == 3 and log.count("Saved ") == 3
    assert log.count("render (fused sharded over 1x2 ranks on cpu)") == 3
    assert "backend gloo" in log
    assert len([n for n in os.listdir(out) if n.endswith(".ppm")]) == 3


def test_sharded_driver_sample_slices(poses, tmp_path, capfd):
    out = tmp_path / "sp2"
    spawn_ranks(driver.main, 2, argv(poses, out, "--shard", "--shard_sp",
                                     "2"), threads=1, timeout=RANKS_TIMEOUT)
    log = capfd.readouterr().out
    assert log.count("render (sharded over 2x1 ranks on cpu)") == 3
    assert len(pngs(out)) == 3


def test_shard_on_cuda_without_a_card_raises(poses, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        # the last --device wins
        driver.main(argv(poses, tmp_path, "--shard", "--device", "cuda"))
    assert not torch.distributed.is_initialized()
