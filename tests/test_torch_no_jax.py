"""dsrt_tpu_torch imports neither JAX nor anything of the JAX package
(dsrt_tpu), puts its tensors on the card unless asked otherwise, and never
falls back from CUDA to CPU."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch import driver
from dsrt_tpu_torch.models.presets import (single_triangle_scene,
                                           volumetric_scene)
from dsrt_tpu_torch.ops import build, path_kernel, sphere_kernel, traverse
from dsrt_tpu_torch.ops.camera import make_camera
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.render import render_frame_fused

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dsrt_tpu_torch"
# any import of JAX, of the JAX package (dsrt_tpu) or of its bench
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|dsrt_tpu|bench)\b(?!_torch)"
    r"|from\s+(jax|dsrt_tpu|bench)\b(?!_torch)[\w.]*\s+import)", re.M)


def test_render_in_subprocess_leaves_jax_unimported():
    code = (
        "import sys\n"
        "import dsrt_tpu_torch\n"
        "from dsrt_tpu_torch import driver, render_frame\n"
        "from dsrt_tpu_torch.models.presets import single_triangle_scene\n"
        "from dsrt_tpu_torch.ops.camera import make_camera\n"
        "from dsrt_tpu_torch.config import RenderConfig\n"
        "from dsrt_tpu_torch.models.mesh_gen import iss_mixed_scene\n"
        "from dsrt_tpu_torch.render import render_frame_wavefront\n"
        "import dsrt_tpu_torch.ops.traverse, dsrt_tpu_torch.native\n"
        "import dsrt_tpu_torch.utils.jpeg, dsrt_tpu_torch.utils.transform\n"
        "cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=8, "
        "height=6, device='cpu')\n"
        "img = render_frame(single_triangle_scene(device='cpu'), cam, "
        "RenderConfig(width=8, height=6, spp=1, max_depth=3))\n"
        "assert img.shape == (6, 8, 3) and img.max() > 0\n"
        "from dsrt_tpu_torch import render_frame_fused, volumetric_scene\n"
        "import dsrt_tpu_torch.ops.sphere_kernel\n"
        "img = render_frame_fused(volumetric_scene(device='cpu'), cam, "
        "RenderConfig(width=8, height=6, spp=1, max_depth=3))\n"
        "assert img.shape == (6, 8, 3)\n"
        "img = render_frame_wavefront(iss_mixed_scene(detail=1, "
        "device='cpu'), cam, RenderConfig(width=8, height=6, spp=2, "
        "max_depth=3), spp_batch=2)\n"
        "assert img.shape == (6, 8, 3)\n"
        "from dsrt_tpu_torch.models import feature_scenes, presets\n"
        "from dsrt_tpu_torch.models.scene import SceneBuilder\n"
        "from dsrt_tpu_torch import Material\n"
        "img = render_frame_fused(presets.cornell_box_scene(device='cpu'), "
        "cam, RenderConfig(width=8, height=6, spp=1, max_depth=3))\n"
        "s = feature_scenes.smooth(SceneBuilder, Material).build("
        "device='cpu')\n"
        "img = render_frame_fused(s, cam, RenderConfig(width=8, height=6, "
        "spp=1, max_depth=3))\n"
        "assert img.shape == (6, 8, 3)\n"
        "import dsrt_tpu_torch.models.esrgan, dsrt_tpu_torch.utils.debug\n"
        "import dsrt_tpu_torch.scripts.upsample\n"
        "from dsrt_tpu_torch.orbit import cli, cr3bp, ephemeris, kepler\n"
        "from dsrt_tpu_torch.orbit import trajectory\n"
        "E = kepler.solve_kepler_E_torch([0.5, 1.0], 0.2, device='cpu')\n"
        "assert str(E.dtype) == 'torch.float64'\n"
        "from dsrt_tpu_torch.parallel import dryrun, mesh, render\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('dsrt_tpu', 'jax', 'jaxlib', 'bench')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_package_source_has_no_jax_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 30
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"
    # the pattern does catch what it must
    for line in ("import dsrt_tpu", "from dsrt_tpu.config import X",
                 "    from dsrt_tpu import native", "import jax.numpy as jnp",
                 "from bench import main"):
        assert FORBIDDEN.search(line), line
    for line in ("import dsrt_tpu_torch", "from dsrt_tpu_torch.ops import x"):
        assert not FORBIDDEN.search(line), line


def private_imports(source: str) -> list:
    """(module, name) of each underscore name that `source` imports from
    a module of dsrt_tpu_torch (dunder names aside)."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").split(".")[0]
                == "dsrt_tpu_torch"):
            out += [(node.module, a.name) for a in node.names
                    if a.name.startswith("_")
                    and not a.name.startswith("__")]
    return out


def test_package_modules_import_no_private_name_of_another():
    """A name two modules of the package share is public in the module
    that owns it: no module imports an underscore name of another."""
    hits = [f"{f.relative_to(ROOT)}: {mod}.{name}"
            for f in sorted(PKG.rglob("*.py"))
            for mod, name in private_imports(f.read_text())]
    assert not hits, hits
    # the scan does catch what it must
    assert private_imports(
        "from dsrt_tpu_torch.ops.path_kernel import (list_launch,\n"
        "    _ptr)\n") == [("dsrt_tpu_torch.ops.path_kernel", "_ptr")]
    assert private_imports("def f():\n    from .build import _lib\n") \
        == [("build", "_lib")]
    assert not private_imports("from __future__ import annotations\n"
                               "from os import _exit\n"
                               "from dsrt_tpu_torch.ops import build\n")


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    scene = single_triangle_scene(device="cpu").to("meta")
    cam = make_camera((0, 0, 1.0), (0, 0, -2), vfov=50, width=8, height=6,
                      device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=3)
    with pytest.raises((ValueError, RuntimeError)):
        path_kernel.path_render(scene, cam, cfg)
    ro = V3(*(torch.zeros(4, device="meta") for _ in range(3)))
    act = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        traverse.traverse(scene, ro, ro, act, 1e-3, 1e9)
    assert path_kernel.LAUNCHES["dsrt_path_render"] == 0
    assert traverse.LAUNCHES["dsrt_traverse"] == 0


def test_non_cpu_sphere_scenes_never_fall_back_to_the_plain_version():
    scene = volumetric_scene(device="cpu").to("meta")
    cam = make_camera((0, 0.6, 2.0), (0, 0, -1), vfov=50, width=8, height=6,
                      device="cpu")
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
        build.require_cuda(torch.device("cuda"))


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


@pytest.mark.parametrize("call", ["scene", "preset", "standin", "camera",
                                  "reference"])
def test_builders_default_to_the_card(monkeypatch, call):
    """Without `device`, builders and cameras put their tensors on CUDA;
    with no card that raises a RuntimeError naming CUDA."""
    from dsrt_tpu_torch.device import resolve_device
    from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
    from dsrt_tpu_torch.models.scene import SceneBuilder, scene_from_reference
    from dsrt_tpu_torch.ops.camera import camera_from_reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"
    cpu_scene = single_triangle_scene(device="cpu")
    cpu_cam = make_camera((0, 0, 1.0), (0, 0, -2), width=8, height=6,
                          device="cpu")
    assert cpu_scene.device.type == "cpu" and cpu_cam.origin.device.type \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"scene": lambda: SceneBuilder().build(),
          "preset": single_triangle_scene,
          "standin": lambda: iss_standin_scene(detail=1),
          "camera": lambda: make_camera((0, 0, 1.0), (0, 0, -2)),
          "reference": lambda: (scene_from_reference(cpu_scene),
                                camera_from_reference(cpu_cam))}[call]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
