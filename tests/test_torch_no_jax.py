"""dsrt_tpu_torch imports no JAX, and never falls back from CUDA to CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dsrt_tpu.config import RenderConfig
from dsrt_tpu_torch import driver
from dsrt_tpu_torch.models.presets import (single_triangle_scene,
                                           volumetric_scene)
from dsrt_tpu_torch.ops import build, path_kernel, sphere_kernel
from dsrt_tpu_torch.ops.camera import make_camera
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.render import render_frame_fused

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dsrt_tpu_torch"
# dsrt_tpu modules that import JAX; the port reuses only JAX-free ones
JAX_MODULES = ("dsrt_tpu.models.scene", "dsrt_tpu.ops", "dsrt_tpu.render",
               "dsrt_tpu.models.presets", "dsrt_tpu.parallel",
               "dsrt_tpu.exec_opts", "dsrt_tpu.oracle", "bench")


def test_render_in_subprocess_leaves_jax_unimported():
    code = (
        "import sys\n"
        "import dsrt_tpu_torch\n"
        "from dsrt_tpu_torch import driver, render_frame\n"
        "from dsrt_tpu_torch.models.presets import single_triangle_scene\n"
        "from dsrt_tpu_torch.ops.camera import make_camera\n"
        "from dsrt_tpu.config import RenderConfig\n"
        "cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=8, "
        "height=6)\n"
        "img = render_frame(single_triangle_scene(), cam, "
        "RenderConfig(width=8, height=6, spp=1, max_depth=3))\n"
        "assert img.shape == (6, 8, 3) and img.max() > 0\n"
        "from dsrt_tpu_torch import render_frame_fused, volumetric_scene\n"
        "import dsrt_tpu_torch.ops.sphere_kernel\n"
        "img = render_frame_fused(volumetric_scene(), cam, "
        "RenderConfig(width=8, height=6, spp=1, max_depth=3))\n"
        "assert img.shape == (6, 8, 3)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_package_source_has_no_jax_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 12
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|"
                     + "|".join(re.escape(m) for m in JAX_MODULES) + r")",
                     re.M)
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    scene = single_triangle_scene().to("meta")
    cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=8, height=6)
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=3)
    with pytest.raises((ValueError, RuntimeError)):
        path_kernel.path_render(scene, cam, cfg)
    ro = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    with pytest.raises((ValueError, RuntimeError)):
        path_kernel.closest_hit(scene, ro, ro)
    assert path_kernel.LAUNCHES["dsrt_path_render"] == 0


def test_non_cpu_sphere_scenes_never_fall_back_to_the_plain_version():
    scene = volumetric_scene().to("meta")
    cam = make_camera((0, 0.6, 2.0), (0, 0, -1), vfov=50, width=8, height=6)
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=3)
    with pytest.raises((ValueError, RuntimeError)):
        sphere_kernel.sphere_render(scene, cam, cfg)
    with pytest.raises((ValueError, RuntimeError)):
        render_frame_fused(scene, cam, cfg)
    assert sphere_kernel.LAUNCHES["dsrt_sphere_render"] == 0


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.resolve_device("cuda")
    assert driver.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        path_kernel._require_cuda(torch.device("cuda"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: this checks a host without the toolkit")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load()
    assert not list(tmp_path.iterdir())
    assert build.library_path().name.startswith("libdsrt_torch_")
