"""Nothing of portbench imports the JAX stack or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.registry import REPO

PKG = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "dsrt_tpu", "bench", "benchmarks"}
# the reference side: what decides `correct` apart from the program's PNGs
REFERENCE = ["reference", "reference_esrgan", "weights", "poses", "standin",
             "pngio", "check", "registry", "work_esrgan"]
# each upscale architecture's file: its weights, reference and work count
STAGES = sorted(p.stem for p in (PKG / "stages").glob("*.py"))


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE
                         + [f"stages/{n}" for n in STAGES])
def test_reference_side_imports_nothing_of_the_program(name):
    assert "dsrt_tpu_torch" not in imports(PKG / f"{name}.py")


def test_reference_side_loads_nothing_of_the_program():
    code = ("import sys\n"
            + "".join(f"import portbench.{n}\n" for n in REFERENCE)
            + "".join(f"portbench.registry.stage({n!r})\n" for n in STAGES)
            + "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'dsrt_tpu_torch', 'dsrt_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import sys\n"
            "from portbench.run import main\n"
            "sys.exit(main(['--workload', 'rdv_b.close6', '--seed', '1',"
            " '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    import shutil
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "rdv_b.close6", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
