"""A copy of the benchmark in a temporary directory, with a cell small
enough for the CPU, for the tests of portbench."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.registry import PKG, REPO

TINY = "tiny.tail3"


def make(tmp: Path, width: int = 64, height: int = 36, spp: int = 6,
         chunk_spp: int = 2, window_poses=(96, 99)) -> Path:
    """BENCHMARK.json and portbench's data under `tmp`, plus the config
    `tiny` (the detail-1 stand-in at width x height, spp in chunks of
    chunk_spp) and the mix `tail3` (poses [window_poses)), as cell
    tiny.tail3: all of it files added to a copy."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / PKG / "configs" /
                      "rdv_b_1080p_1000spp.json").read_text())
    cfg.update(name="tiny", width=width, height=height, spp=spp,
               standin_detail=1, dispatch_rays=width * height * chunk_spp)
    # the cell's own limit at this size: sound runs read 0 here (the
    # program's plain version is the reference's arithmetic), and at 6
    # samples the control and the faults read 39-100%
    cfg["check"].update(frames=2, candidates=1024, lit_pixels=24, any_pixels=4,
                        limits={"frames_missing": 0, "px_mismatch_pct": 5.0})
    (root / PKG / "configs" / "tiny.json").write_text(json.dumps(cfg))
    first, stop = window_poses
    (root / PKG / "traffic" / "tail3.json").write_text(json.dumps(
        {"poses": "data/poses99.txt", "first": first, "stop": stop,
         "stride": 1, "repeat": 1}))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": f"{PKG}/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": TINY, "config": "tiny",
                              "traffic": "tail3", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:        # what rdv_b.close6 reports
        if "rdv_b.close6" in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
