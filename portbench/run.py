"""The benchmark's one command:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout, on a machine with the cards the cell
asks for.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `check`, each number the check compared
beside its limit (also the last lines on standard error).  Without a
card, with fewer cards than the cell asks for, or with the JAX stack or
the JAX package loaded once the window has closed, it prints no result
and exits with another code than 0.  `--control 1` (the reference in
bfloat16) or `--control tf32` (an upscale stage's reference with TF32
on) runs one of the check's controls instead of judging the program's
outputs, and `--fault <name>` plants one of portbench/faults.py's faults
in the timed path; neither is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from portbench import faults, harness

CONTROLS = {"0": None, "1": "bf16", "tf32": "tf32"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=sorted(CONTROLS), default="0")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    t0 = time.perf_counter() - harness.process_start_s()
    try:
        from portbench.registry import Bench
        bench = Bench()
        chips = int(bench.cell(args.workload)["chips"])
        import dsrt_tpu_torch  # noqa: F401  (no program, no run)
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        if args.fault:
            faults.plant(args.fault)
        result, run, verdict = harness.run_cell(
            bench, args.workload, args.seed, args.seconds, bool(args.trace),
            t0=t0, control=CONTROLS[args.control])
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"setup_phases": run.setup_phases}), file=sys.stderr)
    print(json.dumps({"detail": verdict["detail"]}), file=sys.stderr)
    for name, nv in result["check"].items():
        print(f"check {name} {nv['value']!r} limit {nv['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
