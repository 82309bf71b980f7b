"""Spans of the driver's stages and throughput telemetry.

The port's counterpart of dsrt_tpu/utils/timing.py (it imports nothing of
the JAX package).

The reference prints wall-clock chrono spans per stage
(src/main.cpp:247-249, 408-410, 433-436).  Here one recorder,
`StageTimer`, keeps every span of a run in memory: its name, start and
end in ns, its frame id (-1 outside a frame) and its parent span.  A
start or end is `time.perf_counter_ns()` (monotonic, so a duration
never steps with the wall clock) plus one offset to `time.time_ns()`
read when the recorder is made: CLOCK_REALTIME, the clock of a
torch.profiler chrome trace once its `ts` is offset by the trace's
`baseTimeNanoseconds`.  The driver makes its recorder the active one for the length of a
run (`recording`); code below the driver opens a span with the
module-level `span(name)`, which records nothing when no recorder is
active.  While a torch profiler runs, each span also enters
`record_function(name)`, so it shows in the trace as a `user_annotation`
under the same name; with no profiler it enters nothing.  A span reads
no device tensor and waits for nothing.

`StageTimer.write_tsv` writes one row a span, `stage`, `duration_ns`,
`frame` (the TSV that scripts/performance.py plots and
tools/sequence_stats.py reads), and `mrays_per_sec` gives Mrays/s (the
BASELINE.json metric).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler

# the recorder spans go to (recording() sets it), or None
_active: Optional["StageTimer"] = None
_NULL = contextlib.nullcontext()


class _Span:
    """One span of a StageTimer: a record [name, start_ns, end_ns, frame,
    parent] opened on enter and closed on exit; the frame id is the
    parent's unless given."""
    __slots__ = ("timer", "name", "frame", "row", "note")

    def __init__(self, timer: "StageTimer", name: str, frame):
        self.timer, self.name, self.frame = timer, name, frame

    def __enter__(self):
        t = self.timer
        parent = t.open[-1] if t.open else -1
        frame = self.frame
        if frame is None:
            frame = t.records[parent][3] if parent >= 0 else -1
        # the annotation, if any, encloses the clock reads, so the span
        # lies inside its trace event
        self.note = None
        if torch.autograd._profiler_enabled():
            self.note = profiler.record_function(self.name)
            self.note.__enter__()
        start = t.now()
        self.row = len(t.records)
        t.records.append([self.name, start, start, frame, parent])
        t.open.append(self.row)
        return self

    def __exit__(self, *exc):
        t = self.timer
        t.records[self.row][2] = t.now()
        t.open.pop()
        if self.note is not None:
            self.note.__exit__(*exc)
        return False


class StageTimer:
    """The spans of one run, in the order they opened: `records` holds
    [name, start_ns, end_ns, frame, parent] lists, `parent` the index of
    the enclosing span's record (-1 at the top)."""

    def __init__(self) -> None:
        self.records: List[list] = []
        # indices of the open spans' records, innermost last
        self.open: List[int] = []
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def now(self) -> int:
        """The recorder's clock: monotonic ns, on the trace's clock as
        of the recorder's creation."""
        return time.perf_counter_ns() + self.offset_ns

    def stage(self, name: str, frame: Optional[int] = None) -> _Span:
        """A span (context manager) inside the innermost open one; `frame`
        defaults to its parent's frame id."""
        return _Span(self, name, frame)

    def log(self, name: str, start_ns: int, frame: int = -1) -> None:
        """A row from `start_ns` (read from `now`) to now that is not a
        span of the trace: it may overlap spans it does not enclose."""
        parent = self.open[-1] if self.open else -1
        self.records.append([name, start_ns, self.now(), frame, parent])

    def summary(self) -> str:
        """Each stage's total over its closed spans, a line a stage."""
        agg: Dict[str, list] = {}
        for i, (name, t0, t1, _, _) in enumerate(self.records):
            if i not in self.open:
                agg.setdefault(name, []).append((t1 - t0) * 1e-9)
        lines = []
        for name, ds in agg.items():
            lines.append(f"{name}: {sum(ds)*1e3:.1f} ms"
                         + (f" over {len(ds)} calls" if len(ds) > 1 else ""))
        return "\n".join(lines)

    def write_tsv(self, path: str) -> None:
        """One row a span: stage, duration_ns, frame (the frame id, -1
        outside a frame)."""
        with open(path, "w") as fh:
            fh.write("stage\tduration_ns\tframe\n")
            for name, t0, t1, frame, _ in self.records:
                fh.write(f"{name}\t{t1 - t0}\t{frame}\n")


@contextlib.contextmanager
def recording(timer: StageTimer):
    """Make `timer` the recorder that span() opens spans in, for the
    length of the block."""
    global _active
    prev, _active = _active, timer
    try:
        yield timer
    finally:
        _active = prev


def span(name: str, frame: Optional[int] = None):
    """A span in the active recorder (StageTimer.stage), or a context
    that records nothing when none is active."""
    rec = _active
    if rec is None:
        return _NULL
    return rec.stage(name, frame)


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6
