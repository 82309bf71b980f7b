"""Whether the frames the window wrote are correct.

Two numbers, each against the limit the configuration file states under
`check.limits`:

- `frames_missing`: frames of the window's calls with no PNG of the
  frame's size (limit 0);
- `px_mismatch_pct`: the share of the judged pixels, in %, whose u8 RGB
  differs from the plain reference's (portbench/reference.py).

The judged pixels are a sample drawn from the seed once the window has
closed: `check.frames` frames of the window, and in each `lit_pixels`
pixels that the reference itself finds lit (a short 8-sample look at
`candidates` pixels inside the station's projected box, pixels whose
samples disagree first) and `any_pixels` pixels anywhere in the frame.
The reference renders each judged pixel in full: every sample of every
salted launch of the frame.  With `control` the reference computed in
bfloat16 takes the program's place: the check has to fail it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import pngio
from portbench import reference as ref
from portbench.poses import frame_of


def _frame_ok(png: str, width: int, height: int) -> bool:
    try:
        return os.path.exists(png) and pngio.size(png) == (width, height)
    except (OSError, ValueError):
        return False


def station_box(mesh, line: str, vfov: float, width: int, height: int):
    """(x0, x1, y0, y1), inclusive pixel bounds (y from the bottom row),
    of the station's projection; the whole frame when a vertex lies
    behind the camera."""
    cam_pos, _, _ = frame_of(line)
    o, ll, hz, vt = (a.astype(np.float64) for a in
                     ref.camera(cam_pos, vfov, width, height))
    pts = np.concatenate([mesh.v0, mesh.v1, mesh.v2]).astype(np.float64) - o
    fwd = ll + 0.5 * hz + 0.5 * vt - o
    depth = pts @ fwd / (fwd @ fwd)
    if (depth <= 1e-6).any():
        return 0, width - 1, 0, height - 1
    q = pts / depth[:, None] - (ll - o)
    x = (q @ hz) / (hz @ hz) * (width - 1)
    y = (q @ vt) / (vt @ vt) * (height - 1)
    clip = lambda a, n: int(min(max(a, 0), n - 1))
    return (clip(np.floor(x.min()) - 2, width), clip(np.ceil(x.max()) + 2, width),
            clip(np.floor(y.min()) - 2, height),
            clip(np.ceil(y.max()) + 2, height))


def _pick(rng, probe: np.ndarray, cands: list, n: int) -> list:
    partial = ((probe > 0) & (probe < 1)).any(-1)
    lit = (probe > 0).any(-1)
    order = []
    for sel in (partial, lit & ~partial, ~lit):
        idx = np.nonzero(sel)[0]
        order += list(rng.permutation(idx))
    return [cands[i] for i in order[:n]]


def judge(cfg: dict, frames: list, mesh, texture: np.ndarray, seed: int,
          device, control: bool = False) -> dict:
    """`frames`: [(pose line, png path)] of every frame of the window, in
    order.  Returns {"numbers": {name: value}, "limits": {...},
    "correct": bool, "detail": {...}}."""
    t0 = time.perf_counter()
    W, H, spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
    vfov = float(cfg["vfov"])
    chk = cfg["check"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7E57])
    ok = [_frame_ok(p, W, H) for _, p in frames]
    missing = len(frames) - sum(ok)
    k = min(int(chk["frames"]), len(frames))
    chosen = sorted(rng.choice(len(frames), size=k, replace=False)) if k else []

    ctx = ref.Ctx(device)
    tb = ref.Tables(mesh, texture, ctx)
    rcfg = dict(cfg["render"], gamma=float(cfg["gamma"]),
                sun_radiance=tuple(cfg["sun_radiance"]),
                max_depth=int(cfg["max_depth"]))
    cand_lists = []
    for i in chosen:
        x0, x1, y0, y1 = station_box(mesh, frames[i][0], vfov, W, H)
        n = int(chk["candidates"])
        xs = rng.integers(x0, x1 + 1, size=n)
        ys = rng.integers(y0, y1 + 1, size=n)
        cand_lists.append(sorted(set(zip(xs.tolist(), ys.tolist()))))
    probe = ref.radiance_probe(
        ctx, tb, [(frames[i][0], vfov, c) for i, c in zip(chosen, cand_lists)],
        W, H, seed, rcfg).numpy() if chosen else np.zeros((0, 3))
    jobs, start = [], 0
    for i, cands in zip(chosen, cand_lists):
        lit = _pick(rng, probe[start:start + len(cands)], cands,
                    int(chk["lit_pixels"]))
        start += len(cands)
        anyp = list(zip(rng.integers(0, W, size=int(chk["any_pixels"])).tolist(),
                        rng.integers(0, H, size=int(chk["any_pixels"])).tolist()))
        pix = list(dict.fromkeys(lit + anyp))
        jobs.append((frames[i][0], vfov, pix))
    budget = int(cfg["dispatch_rays"])
    want = ref.render_pixels(ctx, tb, jobs, W, H, spp, seed, budget, rcfg)
    if control:
        low = ref.Ctx(device, torch.bfloat16)
        got = ref.render_pixels(low, ref.Tables(mesh, texture, low), jobs,
                                W, H, spp, seed, budget, rcfg)
    else:
        got = []
        for i, (_, _, pix) in zip(chosen, jobs):
            if not ok[i]:
                got.append(None)
                continue
            img = pngio.read_rgb8(frames[i][1])
            got.append(torch.as_tensor(np.stack(
                [img[H - 1 - y, x] for x, y in pix])))
    judged = sum(len(j[2]) for j in jobs)
    bad, shown = 0, []
    for i, (_, _, pix), g, w in zip(chosen, jobs, got, want):
        if g is None:
            bad += len(pix)
            continue
        off = torch.nonzero((g != w).any(-1)).reshape(-1).tolist()
        bad += len(off)
        shown += [[int(i), *pix[j], g[j].tolist(), w[j].tolist()]
                  for j in off][:8 - len(shown)]
    numbers = {"frames_missing": missing,
               "px_mismatch_pct": 100.0 * bad / judged if judged else 100.0}
    limits = {name: float(v) for name, v in chk["limits"].items()}
    return {"numbers": numbers, "limits": limits,
            "correct": all(numbers[n] <= limits[n] for n in limits),
            "detail": {"frames_judged": len(chosen), "pixels_judged": judged,
                       "pixels_mismatched": bad,
                       "first_mismatches": shown,
                       "lit_probe_share": float((probe > 0).any(-1).mean())
                       if len(probe) else 0.0,
                       "seconds": time.perf_counter() - t0}}
