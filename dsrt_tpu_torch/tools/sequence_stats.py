"""Per-frame statistics of a driver run, from its log and its timings TSV.

    python -m dsrt_tpu_torch.driver ... --timings_tsv run.tsv > run.log
    python -m dsrt_tpu_torch.tools.sequence_stats --log run.log --tsv run.tsv

Prints one JSON object (`sequence_stats`): the frames in the order they
finished, each with its index, the camera-model separation [m], the
renderer's label, its render stage [s] (frame issued to image on the
host; with the pipeline a frame's stage overlaps the frame before it on
the card, so the stages can sum to more than the wall), its exact ray
count and Mrays/s over that stage; the render stage's median, p10, p90,
min and max and the slowest frame; the encode stage's total; the frame
loop's wall (the driver's "Total runtime", printed to the millisecond),
the total exact rays and the sustained Mrays/s (total rays over that
wall).
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

FRAME = re.compile(r"^=== Frame (\d+) ===")
SEPARATION = re.compile(r"sep\(cam, model\) = ([0-9.eE+-]+) m")
# the driver's line for a finished frame (driver.finish_frame)
FINISHED = re.compile(r"\[frame (\d+)\] render \((.+)\) \+ wait: .* "
                      r"(\d+) rays exact")
TOTAL = re.compile(r"^Total runtime: ([0-9.]+) s")


def stages(tsv: str) -> dict:
    """{stage: [seconds, ...]} of a --timings_tsv file, in its order."""
    out = {}
    with open(tsv) as fh:
        for ln in fh.readlines()[1:]:
            stage, ns, _ = ln.rstrip("\n").split("\t")
            out.setdefault(stage, []).append(int(ns) / 1e9)
    return out


def parse_log(text: str):
    """([(index, separation, label, rays)] in finish order, the frame
    loop's wall [s] or None) from the driver's stdout."""
    sep, current, frames, wall = {}, None, [], None
    for ln in text.splitlines():
        m = FRAME.match(ln)
        if m:
            current = int(m.group(1))
            continue
        m = SEPARATION.search(ln)
        if m and current is not None:
            sep[current] = float(m.group(1))
            continue
        m = FINISHED.search(ln)
        if m:
            i = int(m.group(1))
            frames.append((i, sep.get(i), m.group(2), int(m.group(3))))
            continue
        m = TOTAL.match(ln)
        if m:
            wall = float(m.group(1))
    return frames, wall


def sequence_stats(log_text: str, tsv: str) -> dict:
    frames, wall = parse_log(log_text)
    st = stages(tsv)
    render = st.get("render", [])
    if len(render) != len(frames):
        raise ValueError(f"{len(frames)} frames in the log, {len(render)} "
                         "render stages in the TSV")
    rows = [dict(index=i, separation_m=s, label=label, render_s=t, rays=n,
                 mrays_per_s=n / t / 1e6)
            for (i, s, label, n), t in zip(frames, render)]
    out = dict(frames=rows, encode_s=sum(st.get("encode", [])),
               scene_compile_s=sum(st.get("scene_compile", [])),
               loop_wall_s=wall)
    if rows:
        t = np.array(render)
        slow = rows[int(np.argmax(t))]
        rays = sum(r["rays"] for r in rows)
        out.update(
            render_s=dict(median=float(np.median(t)),
                          p10=float(np.percentile(t, 10)),
                          p90=float(np.percentile(t, 90)),
                          min=float(t.min()), max=float(t.max()),
                          sum=float(t.sum())),
            slowest=dict(index=slow["index"],
                         separation_m=slow["separation_m"],
                         render_s=slow["render_s"]),
            rays=rays,
            sustained_mrays_per_s=(rays / wall / 1e6 if wall else None))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dsrt_tpu_torch.tools.sequence_stats",
                                description=__doc__.split("\n")[0])
    p.add_argument("--log", required=True, help="the driver's stdout")
    p.add_argument("--tsv", required=True, help="its --timings_tsv file")
    args = p.parse_args(argv)
    with open(args.log) as fh:
        print(json.dumps(sequence_stats(fh.read(), args.tsv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
