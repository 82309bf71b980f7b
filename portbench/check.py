"""Whether the frames the window wrote are correct.

Two numbers, each against the limit the configuration file states under
`check.limits`, and a third where the configuration has an `upscale`
stage, against the limit under `upscale.check.limits`:

- `frames_missing`: frames of the window's calls with no PNG of the
  frame's size, or with a stage no final output of scale x that size
  (limit 0);
- `px_mismatch_pct`: the share of the judged pixels, in %, whose u8 RGB
  differs from the plain reference's (portbench/reference.py);
- `up_mismatch_pct`: the share of the stage's compared output pixels, in
  %, whose u8 RGB differs from the plain reference's (the forward of the
  configuration's `stages/<upscale.arch>.py`, run by
  portbench/reference_esrgan.py `upscale_tiles`) on the same input.

The judged pixels are a sample drawn from the seed once the window has
closed: `check.frames` frames of the window, and in each `lit_pixels`
pixels that the reference itself finds lit (a short 8-sample look at
`candidates` pixels inside the station's projected box, pixels whose
samples disagree first) and `any_pixels` pixels anywhere in the frame.
The reference renders each judged pixel in full: every sample of every
salted launch of the frame.

The stage is judged on `upscale.check.frames` frames of the window drawn
from the seed: the reference upscales the program's own raw PNG of each
(the stage's input as the deployment reads it; that PNG is judged above
against the render's reference), and `upscale.check.tiles` tiles of the
frame's tile grid, drawn from the seed, tiles whose input holds a lit
pixel first (on black input the network gives the constant its biases
make), are compared whole: every output pixel that the stitch keeps from
each.

`control` puts the reference in the program's place, computed in the
precision below the configuration's (the check has to fail it): "bf16",
the render's reference and the stage's in bfloat16; "tf32", the stage's
with TF32 on (the render runs no matmul or conv, so its PNGs are the
program's).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import pngio, registry
from portbench import reference as ref
from portbench.poses import frame_of

CONTROLS = ("bf16", "tf32")


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


def _rng(seed: int, stream: int):
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  stream])


def judge(cfg: dict, frames: list, mesh, texture: np.ndarray, seed: int,
          device, control: str | None = None, weights: str | None = None,
          root=registry.REPO) -> dict:
    """`frames`: [(pose line, png path, final output path)] of every frame
    of the window, in order; `weights`: the stage's seeded checkpoint;
    `root`: the benchmark whose `stages/` holds the stage's architecture.
    Returns {"numbers": {name: value}, "limits": {...}, "correct": bool,
    "detail": {...}}."""
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    t0 = time.perf_counter()
    W, H, spp = int(cfg["width"]), int(cfg["height"]), int(cfg["spp"])
    vfov = float(cfg["vfov"])
    chk = cfg["check"]
    up = cfg.get("upscale")
    rng = _rng(seed, 0x7E57)
    ok = [_frame_ok(p, W, H) for _, p, _ in frames]
    final_ok = ok
    if up:
        s = int(up["scale"])
        final_ok = [_frame_ok(f, s * W, s * H) for _, _, f in frames]
    missing = sum(not (a and b) for a, b in zip(ok, final_ok))
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
    if control == "bf16":
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
    detail = {"frames_judged": len(chosen), "pixels_judged": judged,
              "pixels_mismatched": bad,
              "first_mismatches": shown,
              "lit_probe_share": float((probe > 0).any(-1).mean())
              if len(probe) else 0.0,
              "seconds": time.perf_counter() - t0}
    if up:
        n, d = judge_upscale(cfg, frames, ok, final_ok, seed, device,
                             control, weights, root)
        numbers.update(n)
        limits.update({k: float(v) for k, v in up["check"]["limits"].items()})
        detail["upscale"] = d
    return {"numbers": numbers, "limits": limits,
            "correct": all(numbers[n] <= limits[n] for n in limits),
            "detail": detail}


def judge_upscale(cfg: dict, frames: list, raw_ok: list, final_ok: list,
                  seed: int, device, control: str | None, weights: str,
                  root=registry.REPO) -> tuple:
    """({"up_mismatch_pct": %}, detail) of the stage's outputs: the whole
    of the drawn tiles of the drawn frames against the reference on the
    program's raw PNG of each frame."""
    from portbench import reference_esrgan as rup
    from portbench import weights as weightsmod
    t0 = time.perf_counter()
    up = cfg["upscale"]
    chk = up["check"]
    W, H, s = int(cfg["width"]), int(cfg["height"]), int(up["scale"])
    rng = _rng(seed, 0x5CA1E)
    k = min(int(chk["frames"]), len(frames))
    chosen = sorted(rng.choice(len(frames), size=k, replace=False)) if k else []
    origins, th, tw = rup.grid(H, W, int(up["tile"]), int(up["overlap"]))
    own = rup.owner(origins, H, W, th, tw, int(up["overlap"]), s)
    n_t = min(int(chk["tiles"]), len(origins))
    sd = weightsmod.load(weights, device)
    low = {"bf16": {"dtype": torch.bfloat16}, "tf32": {"tf32": True}}
    bad = judged = computed = in_range = 0
    sums = np.zeros(2)
    shown = []
    for i in chosen:
        raw = pngio.read_rgb8(frames[i][1]) if raw_ok[i] else None
        lit = [raw is not None and bool(raw[y0:y0 + th, x0:x0 + tw].any())
               for y0, x0 in origins]
        order = sorted(rng.permutation(len(origins)), key=lambda t: not lit[t])
        picks = sorted(order[:n_t])
        masks = []
        for t in picks:
            y0, x0 = origins[t]
            ys = slice(y0 * s, (y0 + th) * s)
            xs = slice(x0 * s, (x0 + tw) * s)
            masks.append((ys, xs, own[ys, xs] == t))
        n_px = sum(int(m.sum()) for _, _, m in masks)
        judged += n_px
        if raw is None or (control is None and not final_ok[i]):
            bad += n_px
            continue
        computed += n_px
        batch = rup.tiles(rup.to_float(raw), [origins[t] for t in picks],
                          th, tw)
        want = rup.upscale_tiles(sd, batch, up, device, root=root)
        if control is None:
            img = pngio.read_rgb8(frames[i][2])
            got = [img[ys, xs] for ys, xs, _ in masks]
        else:
            got = rup.upscale_tiles(sd, batch, up, device, root=root,
                                    **low[control])
        for t, w, g, (ys, xs, m) in zip(picks, want, got, masks):
            w = w[:m.shape[0], :m.shape[1]]
            g = g[:m.shape[0], :m.shape[1]]
            off = (g != w).any(-1) & m
            bad += int(off.sum())
            in_range += int(((w >= 1) & (w <= 254))[m].sum())
            v = w[m].astype(np.float64)
            sums += (v.sum(), (v * v).sum())
            for y, x in np.argwhere(off)[:8 - len(shown)]:
                shown.append([int(i), int(t), int(ys.start + y),
                              int(xs.start + x), g[y, x].tolist(),
                              w[y, x].tolist()])
    numbers = {"up_mismatch_pct": 100.0 * bad / judged if judged else 100.0}
    return numbers, {"frames_judged": len(chosen),
                     "tiles_a_frame": n_t, "pixels_judged": judged,
                     "pixels_mismatched": bad, "first_mismatches": shown,
                     "u8_in_1_254_pct": 100.0 * in_range / (3 * computed)
                     if computed else 0.0,
                     "u8_std": float(np.sqrt(max(
                         sums[1] / (3 * computed)
                         - (sums[0] / (3 * computed)) ** 2, 0.0)))
                     if computed else 0.0,
                     "seconds": time.perf_counter() - t0}
