"""Reduction of a torch.profiler chrome trace of the measured window.

The harness marks the window and each driver call with
`record_function("portbench.window")` / `("portbench.call")`; device
activity is every kernel, memcpy and memset event.  The program's own
spans (its StageTimer's, `user_annotation` events while a profiler runs)
are every other annotation: a device event counts to the innermost of
them around the runtime or driver call that launched it, joined by the
events' `args.correlation`, wherever on the device's clock it ran.  Times
in the trace are microseconds; everything returned here is seconds.
"""

from __future__ import annotations

import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
CALL = "portbench.call"
HARNESS = "portbench."
# a gap's label where the host is in the harness's window or driver call
# and in none of the program's spans
BETWEEN_CALLS = "harness between driver calls"
IN_CALL = "driver host code outside torch ops"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: dict            # device op name -> (seconds, count)
    gaps: list           # [(label, seconds)], longest first, at most 10
    span_ops: dict       # program span name -> (device seconds, launches)


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
        return BETWEEN_CALLS
    if inner["name"] == CALL:
        return IN_CALL
    return inner["name"]


def _innermost(spans: list, points: list) -> dict:
    """{key: name} of the innermost span around each point, for one
    thread's nested spans [(t0, t1, name)] and points [(t, key)]."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _launch_spans(events: list) -> dict:
    """{correlation id: the program span around the call that launched
    it}, for every launching runtime or driver call inside one."""
    spans, points = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        thread = (e.get("pid"), e.get("tid"))
        if e.get("cat") == "user_annotation" \
                and not e["name"].startswith(HARNESS):
            t0 = float(e["ts"])
            spans.setdefault(thread, []).append(
                (t0, t0 + float(e.get("dur", 0.0)), e["name"]))
        elif e.get("cat") in LAUNCH_CATS \
                and "correlation" in e.get("args", {}):
            points.setdefault(thread, []).append(
                (float(e["ts"]), e["args"]["correlation"]))
    out = {}
    for thread, pts in points.items():
        out.update(_innermost(spans.get(thread, []), pts))
    return out


def reduce(events: list) -> Trace:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no portbench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launched_in = _launch_spans(events)
    dev, ops, span_ops = [], {}, {}
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
        span = launched_in.get(e.get("args", {}).get("correlation"))
        if span is not None:
            s, n = span_ops.get(span, (0.0, 0))
            span_ops[span] = (s + (b - a) * 1e-6, n + 1)
    busy = _union(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and w0 <= float(e["ts"]) <= w1]
    labelled = [(_label(host, a + d / 2), d * 1e-6) for d, a in gaps]
    return Trace((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
                 ops, labelled, span_ops)


def load(path: str) -> Trace:
    with open(path) as fh:
        return reduce(json.load(fh)["traceEvents"])


def breakdown(tr: Trace) -> dict:
    top = sorted(((n, s) for n, (s, _) in tr.ops.items()),
                 key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[lab, s] for lab, s in tr.gaps]}
