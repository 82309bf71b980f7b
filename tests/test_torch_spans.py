"""The driver's spans (dsrt_tpu_torch/utils/timing.py) and the benchmark
readers and trace labels that read them, on the CPU.

A driver run with --timings_tsv writes one `inputs`, `issue`, `wait` and
`encode` row a frame under the PNG's number, one `launch` row a
path-kernel call and one `run` row, each child inside its parent; under
torch.profiler every span but `render` is a `user_annotation` of the same
name on the same clock; with no profiler no annotation is entered, and
the PNGs are the same bytes either way.
"""

import json
import os

import pytest
import torch

from dsrt_tpu_torch import driver
from dsrt_tpu_torch.ops import path_kernel
from dsrt_tpu_torch.utils import timing
from portbench import trace as tracemod
from portbench.harness import Frame, Run
from portbench.registry import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSES = os.path.join(ROOT, "portbench", "data", "poses99.txt")
FRAME_SPANS = ("inputs", "issue", "wait", "encode")
# 16x12 at 4 spp in salted chunks of 2 spp: two launches a frame
ARGS = ["--device", "cpu", "--width", "16", "--height", "12", "--spp", "4",
        "--max_depth", "3", "--standin_detail", "1", "--dispatch_rays",
        str(16 * 12 * 2)]


def _pose_file(tmp_path, first=96, n=3):
    """n close poses of the rendezvous (pose lines first..first+n-1)."""
    with open(POSES) as fh:
        lines = [ln for ln in fh if not ln.startswith("#")]
    path = tmp_path / "poses.txt"
    path.write_text("".join(lines[first:first + n]))
    return str(path)


def _drive(tmp_path, monkeypatch, out="out", extra=()):
    """Run the driver over 3 poses from frame 1; returns (its StageTimer,
    the TSV rows as (stage, ns, frame), the output dir, path_render
    calls)."""
    timers, calls = [], []

    class Kept(timing.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    real = path_kernel._path_render

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(driver, "StageTimer", Kept)
    monkeypatch.setattr(path_kernel, "_path_render", counted)
    out_dir = tmp_path / out
    tsv = tmp_path / f"{out}.tsv"
    assert driver.main(ARGS + ["--input_txt", _pose_file(tmp_path),
                               "--output_dir", str(out_dir), "--start_frame",
                               "1", "--timings_tsv", str(tsv),
                               *extra]) == 0
    with open(tsv) as fh:
        assert next(fh) == "stage\tduration_ns\tframe\n"
        rows = [(s, int(ns), int(f)) for s, ns, f in
                (ln.rstrip("\n").split("\t") for ln in fh)]
    assert len(timers) == 1
    return timers[0], rows, out_dir, len(calls)


def test_driver_writes_a_span_a_stage_a_frame(tmp_path, monkeypatch):
    timer, rows, out, n_launch = _drive(tmp_path, monkeypatch)
    pngs = sorted(os.listdir(out))
    assert pngs == ["frame_0001.png", "frame_0002.png"]
    ids = [int(p[6:10]) for p in pngs]
    for stage in FRAME_SPANS + ("render",):
        assert sorted(f for s, _, f in rows if s == stage) == ids, stage
    assert n_launch == 2 * len(ids)
    launches = [f for s, _, f in rows if s == "launch"]
    assert sorted(launches) == sorted(ids * 2)
    assert [f for s, _, f in rows if s == "run"] == [-1]
    assert {s for s, _, _ in rows} == set(FRAME_SPANS) | {
        "run", "launch", "render", "mesh_load", "scene_compile"}
    assert all(ns >= 0 for _, ns, _ in rows)
    # the TSV holds the records, and each child lies inside its parent
    assert [(r[0], r[2] - r[1], r[3]) for r in timer.records] == rows
    recs = timer.records
    parents = {}
    for name, t0, t1, frame, parent in recs:
        assert t0 <= t1
        if name == "run":
            assert parent == -1
            continue
        p = recs[parent]
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
        parents.setdefault(name, set()).add(p[0])
    assert parents["launch"] == {"issue"}
    for name in FRAME_SPANS + ("render", "mesh_load", "scene_compile"):
        assert parents[name] == {"run"}, name
    assert timer.open == []


def test_spans_are_profiler_annotations_on_its_clock(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the process's first annotation pays a one-off set-up
        with torch.profiler.record_function("warm-up"):
            pass
        timer, _, _, _ = _drive(tmp_path, monkeypatch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1000
    spans = [r for r in timer.records if r[0] != "render"]
    names = {r[0] for r in spans}
    notes = sorted((e for e in doc["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in names), key=lambda e: e["ts"])
    assert "render" not in {e["name"] for e in doc["traceEvents"]
                            if e.get("cat") == "user_annotation"}
    assert [e["name"] for e in notes] == [r[0] for r in spans]
    for e, r in zip(notes, spans):
        assert abs(e["ts"] + base_us - r[1] / 1000) < 1000, r[0]
        assert abs(e["ts"] + e["dur"] + base_us - r[2] / 1000) < 1000, r[0]


def test_no_profiler_no_annotation_and_the_same_pngs(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, traced, _ = _drive(tmp_path, monkeypatch, "traced")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, _, plain, _ = _drive(tmp_path, monkeypatch, "plain")
    pngs = sorted(os.listdir(plain))
    assert pngs == sorted(os.listdir(traced)) and pngs
    for p in pngs:
        assert (plain / p).read_bytes() == (traced / p).read_bytes(), p


def test_span_without_a_recorder_records_nothing():
    assert timing._active is None
    with timing.span("launch") as s:
        assert s is None
    timer = timing.StageTimer()
    with timing.recording(timer):
        with timing.span("issue", frame=7):
            with timing.span("launch"):
                pass
        with timing.recording(timing.StageTimer()):
            with timing.span("elsewhere"):
                pass
    assert timing._active is None
    assert [(r[0], r[3], r[4]) for r in timer.records] == [
        ("issue", 7, -1), ("launch", 7, 0)]


def test_a_wall_clock_step_moves_no_duration(monkeypatch):
    """Starts and ends are the monotonic clock plus the offset read when
    the recorder was made: a step of the wall clock later changes no
    span's length."""
    mono = iter(range(1_000, 10 ** 6, 1_000))
    wall = iter([5 * 10 ** 18, 10 ** 15])   # then steps back
    monkeypatch.setattr(timing.time, "perf_counter_ns", lambda: next(mono))
    monkeypatch.setattr(timing.time, "time_ns", lambda: next(wall))
    timer = timing.StageTimer()
    assert timer.offset_ns == 5 * 10 ** 18 - 1_000
    with timing.recording(timer), timing.span("issue", frame=3):
        timer.log("render", timer.now(), frame=3)
    assert [(r[0], r[2] - r[1]) for r in timer.records] == [
        ("issue", 3_000), ("render", 1_000)]
    assert timer.records[0][1] == 5 * 10 ** 18 + 1_000


def _run_with(rows, written=2):
    run = Run()
    run.frames = [Frame(0, i, "", "", 0.1) for i in range(written)]
    run.tsv = rows
    return run


CANNED = [("run", 9.0), ("inputs", 0.002), ("issue", 0.003),
          ("launch", 0.001), ("launch", 0.0005), ("inputs", 0.004),
          ("issue", 0.001), ("launch", 0.0015), ("wait", 0.0005),
          ("render", 0.02), ("encode", 0.01), ("wait", 0.0015),
          ("render", 0.03), ("encode", 0.02)]
EXPECT = {"driver.inputs_ms": 3.0, "driver.wait_ms": 1.0,
          "render.host_ms": 2.0, "path_kernel.wrapper_ms": 1.5}


@pytest.mark.parametrize("name", [f"{q}.{c}" for q in sorted(EXPECT)
                                  for c in ("rdv_b", "rdv_a")])
def test_span_readers_on_a_canned_tsv(name):
    read = Bench().reader(name)
    assert read(_run_with(CANNED)) == pytest.approx(
        EXPECT[name.rsplit(".", 1)[0]])
    # a program without the spans, and a window without PNGs: nothing
    assert read(_run_with([("render", 0.02), ("encode", 0.01)])) is None
    assert read(_run_with(CANNED, written=0)) is None


def test_span_metrics_are_in_the_benchmark():
    b = Bench()
    for cell in ("rdv_b.close6", "rdv_a.close6"):
        short = cell.split(".")[0]
        names = {m["name"]: m for m in b.metrics(cell, "per_layer")}
        for q in EXPECT:
            m = names[f"{q}.{short}"]
            assert (m["source"], m["unit"], m["better"], m["moves"]) == (
                "program_span", "ms/frame", "lower", f"s_per_frame.{short}")


def test_trace_names_a_gap_by_the_program_span_around_it():
    """Gaps inside the driver's `inputs` and `run` annotations read their
    names; one in the harness's call outside `run` keeps the harness's
    label."""
    def note(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur}

    def kernel(ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur}

    ev = [note(tracemod.WINDOW, 0.0, 1000.0), note(tracemod.CALL, 0.0, 990.0),
          note("run", 50.0, 900.0), note("inputs", 200.0, 200.0),
          kernel(0.0, 20.0), kernel(60.0, 190.0), kernel(350.0, 350.0),
          kernel(720.0, 280.0)]
    gaps = {round(s * 1e6): lab for lab, s in tracemod.reduce(ev).gaps}
    assert gaps == {100: "inputs",                 # 250-350
                    20: "run",                     # 700-720
                    40: "driver host code outside torch ops"}  # 20-60
