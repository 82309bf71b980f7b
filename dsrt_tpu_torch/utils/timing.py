"""Stage timing and throughput telemetry.

A copy of dsrt_tpu/utils/timing.py: the port imports nothing of the JAX package.

The reference prints wall-clock chrono spans per stage
(src/main.cpp:247-249, 408-410, 433-436) and once had a thread-scaling TSV
consumed by scripts/performance.py.  Here: a Timer registry that prints the
same per-stage lines, computes Mrays/sec (the BASELINE.json metric), and
emits a TSV (`timings.tsv`) compatible with scripts/performance.py.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class StageTimer:
    def __init__(self) -> None:
        self.records: List[tuple] = []  # (stage, seconds, extra)

    @contextlib.contextmanager
    def stage(self, name: str, **extra):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.records.append((name, dt, extra))

    def log(self, name: str, seconds: float, **extra) -> None:
        self.records.append((name, seconds, extra))

    def total(self, name: Optional[str] = None) -> float:
        return sum(r[1] for r in self.records if name is None or r[0] == name)

    def summary(self) -> str:
        agg: Dict[str, list] = {}
        for name, dt, _ in self.records:
            agg.setdefault(name, []).append(dt)
        lines = []
        for name, ds in agg.items():
            lines.append(f"{name}: {sum(ds)*1e3:.1f} ms"
                         + (f" over {len(ds)} calls" if len(ds) > 1 else ""))
        return "\n".join(lines)

    def write_tsv(self, path: str) -> None:
        """TSV with duration_ns column (scripts/performance.py contract)."""
        with open(path, "w") as fh:
            fh.write("stage\tduration_ns\tindex\n")
            for i, (name, dt, _) in enumerate(self.records):
                fh.write(f"{name}\t{int(dt*1e9)}\t{i}\n")


def estimate_rays(width: int, height: int, spp: int,
                  avg_bounces: float = 2.0, shadow_rays: bool = True) -> int:
    """Ray-count estimate for Mrays/sec: primary+bounce rays per sample,
    plus one shadow ray per diffuse bounce when the sun is on."""
    per_sample = avg_bounces * (2.0 if shadow_rays else 1.0)
    return int(width * height * spp * per_sample)


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6
