"""Readings for an upscale stage's limit, taken through the harness.

    python3 -m portbench.stage_calibration --out readings.jsonl \
        [--config rdv_a_x4] [--poses 93 99] [--sound 10] [--controls 3] \
        [--faults upstale bicubic noblock] [--seed0 N]

Adds, in a copy of the benchmark in a temporary directory, the
configuration `--config` as its file has it (the render half and the
`upscale` stage, with `--changes` and `--stage` applied) as `x4cal`, and
a cell over the poses [first, stop) once, then runs that cell in this
process through `harness.run_cell` with a one-call window: on `--sound`
seeds as it is, on `--controls` seeds under each of check.CONTROLS, and
once under each stage fault.  The run under test is the program's stage,
reached through the driver's `--upscale` with the seeded checkpoint that
the configuration's `driver_flags` hand it (`--upscale_weights
{weights}`).  A new architecture's limit is calibrated by naming its
configuration; `noblock` is RRDBNet's only.  One JSON line a run goes to
`--out`: the check's numbers and limits, the stage's detail (with
`u8_in_1_254_pct`, the reference's u8 values inside 1..254) and the
run's set-up, window and peak memory.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time

from portbench import check, faults, harness
from portbench.registry import Bench, copy_with_cell

CELL = "x4cal.poses"


def one(bench, seed: int, device: str, control=None, fault=None) -> dict:
    saved = None
    if fault:
        mod_name, attr, _ = faults.FAULTS[fault]
        mod = importlib.import_module(f"dsrt_tpu_torch.{mod_name}")
        saved = (mod, attr, getattr(mod, attr))
        faults.plant(fault)
    t0 = time.perf_counter()
    try:
        res, run, verdict = harness.run_cell(bench, CELL, seed, 0.1, False,
                                             device=device, control=control)
    finally:
        if saved:
            setattr(*saved)
    return {"kind": fault or control or "sound", "seed": seed,
            "correct": res["correct"], "numbers": verdict["numbers"],
            "limits": verdict["limits"],
            "upscale": verdict["detail"].get("upscale"),
            "render_check_s": verdict["detail"]["seconds"],
            "frames": len(run.frames), "written": run.written,
            "window_s": run.window_s,
            "waits": [f.wait_s for f in run.frames],
            "setup_phases": run.setup_phases,
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "device": res["device"]["kind"],
            "run_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.stage_calibration")
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="rdv_a_x4",
                   help="the configuration whose stage is calibrated")
    p.add_argument("--poses", type=int, nargs=2, default=(93, 99))
    p.add_argument("--sound", type=int, default=10)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", nargs="*",
                   default=["upstale", "bicubic", "noblock"])
    p.add_argument("--seed0", type=int, default=3_180_000_000)
    p.add_argument("--stage", default="{}",
                   help="JSON of keys to change in the configuration's "
                        "upscale stage")
    p.add_argument("--changes", default=json.dumps(
        {"check": {"frames": 2, "candidates": 8192, "lit_pixels": 64,
                   "any_pixels": 16, "limits": {"frames_missing": 0,
                                                "px_mismatch_pct": 2.0}}}),
        help="JSON of top-level keys to change in the configuration (by "
             "default the render's check on 2 frames)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = Bench().config(args.config)
    if "upscale" not in cfg:
        p.error(f"configuration {args.config!r} has no upscale stage")
    stage = dict(cfg["upscale"], **json.loads(args.stage))
    plan = [(args.seed0 + i, None, None) for i in range(args.sound)]
    plan += [(args.seed0 + 100 + i, c, None) for c in check.CONTROLS
             for i in range(args.controls)]
    plan += [(args.seed0 + 200 + i, None, f)
             for i, f in enumerate(args.faults)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg.update(json.loads(args.changes), name="x4cal", upscale=stage)
        first, stop = args.poses
        bench = Bench(copy_with_cell(
            tmp, cfg, "x4cal", {"poses": "data/poses99.txt", "first": first,
                                "stop": stop, "stride": 1, "repeat": 1},
            CELL, "rdv_a.close6"))
        with open(args.out, "a") as fh:
            for seed, control, fault in plan:
                rec = one(bench, seed, args.device, control, fault)
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                up = rec["upscale"] or {}
                print(f"{rec['kind']:8s} seed {seed} "
                      f"px {rec['numbers']['px_mismatch_pct']:.4f} "
                      f"up {rec['numbers'].get('up_mismatch_pct', -1):.5f} "
                      f"in1-254 {up.get('u8_in_1_254_pct', -1):.2f}% "
                      f"check_up {up.get('seconds', -1):.2f} s "
                      f"render_check {rec['render_check_s']:.2f} s "
                      f"window {rec['window_s']:.2f} s "
                      f"run {rec['run_s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
