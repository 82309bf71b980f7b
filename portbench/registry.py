"""Everything the harness runs is found by name from files.

- a cell is an entry of `workloads` in BENCHMARK.json;
- its configuration is the JSON file that BENCHMARK.json's `configs`
  entry names;
- its traffic mix is `<bench>/traffic/<traffic>.json`, read by the one
  general generator, portbench/traffic.py;
- a metric, end-to-end or per-layer, is read by
  `<bench>/metrics/<name>.py`, a module with `read(run) -> float | None`
  (or, where there is no such file, by the reader of the name cut at its
  last dot);
- an upscale stage's architecture, the configuration's `upscale.arch`, is
  `<bench>/stages/<arch>.py`, a module with `make_weights(up, seed,
  device)`, `forward(sd, x, up)`, `tile_flops(up, th, tw)` and
  `param_count(up)` (README.md, "an upscale architecture").

`Bench(root)` looks under `root` (a checkout, or any directory laid out
the same way), so a new cell, mix, metric or architecture is added by
adding files.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

PKG = "portbench"
REPO = Path(__file__).resolve().parent.parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage(arch: str, root=REPO):
    """The module of the upscale architecture `arch`:
    `<root>/portbench/stages/<arch>.py`; ValueError naming that file where
    there is none."""
    path = Path(root) / PKG / "stages" / f"{arch}.py"
    if not isinstance(arch, str) or "/" in arch or not path.is_file():
        raise ValueError(f"unknown stage architecture {arch!r}: no file "
                         f"{path}")
    return _load(path, f"{PKG}_stage_{arch}")


class Bench:
    def __init__(self, root=REPO):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / PKG

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def data(self, rel: str) -> Path:
        return self.dir / rel

    def metrics(self, cell: str, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries that `cell` reports:
        those that list it under `workloads`, and those without the key:
        an end-to-end metric in every cell, a per-layer metric in every
        cell that reports the end-to-end metric it `moves`."""
        found = [m for m in self.spec[kind]
                 if cell in m.get("workloads", [cell])]
        if kind == "per_layer":
            e2e = {m["name"] for m in self.metrics(cell, "end_to_end")}
            found = [m for m in found
                     if "workloads" in m or m["moves"] in e2e]
        return found

    def reader_file(self, name: str) -> Path:
        """metrics/<name>.py or, where there is none, the file of the name
        cut at its last dot, and so on: a quantity split by configuration
        (`s_per_frame.rdv_b`) is read by the quantity's reader."""
        stem = name
        while not (self.dir / "metrics" / f"{stem}.py").exists() \
                and "." in stem:
            stem = stem.rsplit(".", 1)[0]
        return self.dir / "metrics" / f"{stem}.py"

    def reader(self, name: str):
        return _load(self.reader_file(name),
                     f"{PKG}_metric_{name.replace('.', '_')}").read


def copy_with_cell(dest, cfg: dict, mix_name: str, mix: dict, cell: str,
                   like: str, files: dict | None = None) -> Path:
    """A copy of the benchmark under `dest`/bench (BENCHMARK.json and
    portbench without its tests) with, added as files and entries, the
    configuration `cfg` (named by its "name"), the traffic mix `mix`
    named `mix_name`, the cell `cell` over them, which reports the
    metrics, end-to-end and per-layer, whose `workloads` list the cell
    `like`, and `files` ({path under portbench: text}, none of them a
    file the benchmark has)."""
    root = Path(dest) / "bench"
    shutil.copytree(REPO / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, text in (files or {}).items():
        path = root / PKG / rel
        if path.exists():
            raise FileExistsError(f"{path}: files are added, not replaced")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    name = cfg["name"]
    (root / PKG / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (root / PKG / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"{PKG}/configs/{name}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": mix_name, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
