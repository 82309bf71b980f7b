"""Reduction of a torch.profiler chrome trace of the measured window.

The harness marks the window and each driver call with
`record_function("portbench.window")` / `("portbench.call")`; device
activity is every kernel, memcpy and memset event.  Times in the trace are
microseconds; everything returned here is seconds.
"""

from __future__ import annotations

import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "portbench.window"
CALL = "portbench.call"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: dict            # device op name -> (seconds, count)
    gaps: list           # [(label, seconds)], longest first, at most 10


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(host, t: float) -> str:
    """What the host was doing at time t: the innermost host event around
    it, the harness's own spans named as such."""
    inner = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (
                inner is None or e["dur"] < inner["dur"]):
            inner = e
    if inner is None or inner["name"] == WINDOW:
        return "harness between driver calls"
    if inner["name"] == CALL:
        return "driver host code outside torch ops"
    return inner["name"]


def reduce(events: list) -> Trace:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no portbench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ops = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        s, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (s + (b - a) * 1e-6, n + 1)
    busy = _union(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and w0 <= float(e["ts"]) <= w1]
    labelled = [(_label(host, a + d / 2), d * 1e-6) for d, a in gaps]
    return Trace((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
                 ops, labelled)


def load(path: str) -> Trace:
    with open(path) as fh:
        return reduce(json.load(fh)["traceEvents"])


def breakdown(tr: Trace) -> dict:
    top = sorted(((n, s) for n, (s, _) in tr.ops.items()),
                 key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[lab, s] for lab, s in tr.gaps]}
