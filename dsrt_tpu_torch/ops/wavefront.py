"""The split pipeline's wave loops (port of dsrt_tpu/ops/wavefront.py).

Both loops run one path segment per wave for a pool of lanes through
ops/shade.bounce_step, whose scene queries go through the traversal
kernels (`walk="kernel"`; their plain versions on CPU tensors):

- `trace_accumulate` (JAX :35-176): every lane owns one pixel and one
  sample slot and starts its next sample the moment its path ends,
  banking clamp01(L) into a per-lane accumulator.  Sample s of slot b
  covers stratum s*B + b; slot b's stream is seed ^ (b * SLOT_SEED_MIX).
- `trace_queue` (JAX :179-335): all (pixel, sample) units of the frame
  form one queue, stratum-major (sid = s * npix + pix); an idle lane pops
  the next unit through an exclusive prefix sum over the dead lanes, and
  completed samples are banked per pixel with a scatter-add.

Each runs in two phases: full width while the busy set is larger than
1/16 of the pool, then the busy lanes are compacted (a stable sort, so
lanes keep their order) into a pool of 1/16 the rows and drained.  The
lane layout and the drain cap match JAX's lane for lane, so the draws,
the pixels and the exact ray counts do too.

Seeds and LCG states ride in int64 masked to 32 bits (PyTorch's CPU build
has no uint32 arithmetic); ray counts are int64.  The loop reads one
flag back to the host a wave, its test (the shading's rejection samplers
add their own retry tests, ops/rng.py); the jitter divides by a device
tensor (a division by a host scalar would become a reciprocal multiply on
CUDA).  The queue banks with `index_put_(accumulate=True)`, which on the
CPU adds in lane order and on CUDA sorts the lanes by pixel with a
stable sort and adds each pixel's values in that order: both are
deterministic and equal JAX's order of updates.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops.camera import camera_rays
from dsrt_tpu_torch.ops.linalg import V3, clamp01, const, where as vwhere
from dsrt_tpu_torch.ops.shade import bounce_step, check_scope, sun_direction
from dsrt_tpu_torch.ops.traverse import sun_vector

SLOT_SEED_MIX = 0x9E3779B9


def _v3(shape, dev, value: float = 0.0) -> V3:
    return V3(*(torch.full(shape, value, dtype=torch.float32, device=dev)
                for _ in range(3)))


def _frame_consts(scene, cfg):
    sdir = sun_direction(scene)
    return dict(max_depth=cfg.resolved_max_depth(),
                with_time=cfg.time1 > cfg.time0,
                t0=float(np.float32(cfg.time0)),
                dt=float(np.float32(cfg.time1 - cfg.time0)),
                sdir=sdir, sun_vec=sun_vector(sdir, cfg.shadow_bias))


def _start(c, need, cro, crd, state, k, ut=None):
    """Lanes in `need` start a fresh path from (cro, crd)."""
    shape = need.shape
    dev = need.device
    c["ro"] = vwhere(need, cro, c["ro"])
    c["rd"] = vwhere(need, crd, c["rd"])
    c["L"] = vwhere(need, _v3(shape, dev), c["L"])
    c["thr"] = vwhere(need, _v3(shape, dev, 1.0), c["thr"])
    c["depth"] = torch.where(need, 0, c["depth"])
    if ut is not None:
        c["time"] = torch.where(need, k["t0"] + ut * k["dt"], c["time"])
    c["state"] = state
    c["alive"] = c["alive"] | need


def _segment(scene, cfg, c, k, walk: str):
    """One path segment on every lane; returns the lanes whose sample
    ended in it and clamp01(L).  Updates `c` in place."""
    alive = c["alive"]
    rr_mask = alive & (c["depth"] >= cfg.rr_start_depth)
    L, thr, ro, rd, state, alive2, nr = bounce_step(
        scene, cfg, c["L"], c["thr"], c["ro"], c["rd"], c["state"], alive,
        rr_mask, k["sdir"], k["sun_vec"],
        c.get("time") if k["with_time"] else None, walk=walk)
    c["depth"] = c["depth"] + alive.to(torch.int64)
    alive2 = alive2 & (c["depth"] < k["max_depth"])
    c.update(L=L, thr=thr, ro=ro, rd=rd, state=state, alive=alive2,
             nrays=c["nrays"] + nr)
    return alive & ~alive2, clamp01(L)


def _compact(c, keep_mask, cap_rows: int, width: int, lanes: dict):
    """Stable compaction: the lanes of `keep_mask` first, in lane order,
    cut to cap_rows x width; state that is not per lane (counters, the
    queue's per-pixel sums) passes through.  Returns (order, compacted
    state, compacted lanes)."""
    order = torch.argsort((~keep_mask.reshape(-1)).to(torch.int8),
                          stable=True)[:cap_rows * width]

    def take(a):
        return a.reshape(-1)[order].reshape(cap_rows, width)

    small = {}
    for key, val in c.items():
        if isinstance(val, V3):
            small[key] = V3(*(take(x) for x in val))
        elif val.shape == keep_mask.shape:
            small[key] = take(val)
        else:
            small[key] = val
    return order, small, {key: take(v) for key, v in lanes.items()}


def trace_accumulate(scene, cfg, cam, px, py, valid, slot, spp_local: int,
                     walk: str = "kernel"):
    """Trace `spp_local` samples on every lane with regeneration.

    px / py / valid / slot are (rows, 1024) lane tensors on the scene's
    device (slot: the sample slot of the lane).  Returns (accum V3, the
    sum over the lane's samples of clamp01(L); exact ray count, int64)."""
    check_scope(scene, cfg)
    shape = px.shape
    dev = px.device
    cam = cam.to(dev)
    k = _frame_consts(scene, cfg)
    spp_total = cfg.resolved_spp()
    batch = spp_total // max(spp_local, 1)
    spp_t = const(spp_total, dev)
    mix = (slot.to(torch.int64) * SLOT_SEED_MIX) & rngmod.MASK32
    izero = torch.zeros(shape, dtype=torch.int64, device=dev)
    c = dict(accum=_v3(shape, dev), L=_v3(shape, dev),
             thr=_v3(shape, dev, 1.0), ro=_v3(shape, dev),
             rd=V3(*_v3(shape, dev)[:2], torch.ones(shape, device=dev)),
             state=rngmod.seed_pixels(px, py, cam.width, scene.seed) ^ mix,
             alive=torch.zeros(shape, dtype=torch.bool, device=dev),
             depth=izero, scnt=izero,
             nrays=torch.zeros((), dtype=torch.int64, device=dev))
    if k["with_time"]:
        c["time"] = torch.zeros(shape, dtype=torch.float32, device=dev)

    def busy(c, valid):
        return c["alive"] | (valid & (c["scnt"] < spp_local))

    def wave(c, px, py, valid, slot):
        # regeneration: idle lanes start their next sample
        need = valid & ~c["alive"] & (c["scnt"] < spp_local)
        state = c["state"]
        jxu, state = rngmod.draw(state, need)
        jyu, state = rngmod.draw(state, need)
        s_global = ((c["scnt"] * batch).to(torch.float32)
                    + slot.to(torch.float32))
        jx = (s_global + jxu) / spp_t
        jy = (s_global + jyu) / spp_t
        cro, crd, state = camera_rays(cam, px, py, jx, jy, state, need,
                                      cfg.aperture > 0)
        ut = None
        if k["with_time"]:
            ut, state = rngmod.draw(state, need)
        _start(c, need, cro, crd, state, k, ut)
        c["scnt"] = c["scnt"] + need.to(torch.int64)
        died, lc = _segment(scene, cfg, c, k, walk)
        c["accum"] = vwhere(died, c["accum"] + lc, c["accum"])

    # phase 1: full width until the busy set fits the drain pool
    cap_rows = max(shape[0] // 16, 1)
    cap = cap_rows * shape[1]
    while int(busy(c, valid).sum()) > cap:
        wave(c, px, py, valid, slot)

    # compaction into the drain pool, then drain
    lanes = dict(px=px, py=py, valid=valid, slot=slot)
    order, small, sl = _compact(c, busy(c, valid), cap_rows, shape[1], lanes)
    while bool(busy(small, sl["valid"]).any()):
        wave(small, sl["px"], sl["py"], sl["valid"], sl["slot"])

    # the drained lanes' accumulators replace their stale copies
    accum = []
    for full, part in zip(c["accum"], small["accum"]):
        flat = full.reshape(-1).clone()
        flat[order] = part.reshape(-1)
        accum.append(flat.reshape(shape))
    return V3(*accum), small["nrays"]


def trace_queue(scene, cfg, cam, width: int, height: int, pool_shape,
                y0: int = 0, walk: str = "kernel"):
    """Global work queue over the (pixel, sample) units of a width x
    height band whose first row is frame row y0, traced by a pool of
    `pool_shape` lanes.  Returns (accum (width*height, 3) float32, the
    sum of clamp01(L) per pixel; exact ray count, int64)."""
    check_scope(scene, cfg)
    dev = scene.device
    cam = cam.to(dev)
    shape = tuple(pool_shape)
    npix = width * height
    spp = cfg.resolved_spp()
    total = npix * spp
    pool = int(np.prod(shape))
    if total + pool >= 2 ** 31:
        raise ValueError(
            f"work-queue id space {total} + pool {pool} overflows int32; "
            "render.render_frame_queue auto-bands the frame — pass a "
            "band height such that width*band_h*spp fits int32")
    k = _frame_consts(scene, cfg)
    spp_t = const(spp, dev)
    izero = torch.zeros(shape, dtype=torch.int64, device=dev)
    c = dict(accum_q=torch.zeros((npix, 3), dtype=torch.float32, device=dev),
             L=_v3(shape, dev), thr=_v3(shape, dev, 1.0), ro=_v3(shape, dev),
             rd=V3(*_v3(shape, dev)[:2], torch.ones(shape, device=dev)),
             state=izero, alive=torch.zeros(shape, dtype=torch.bool,
                                            device=dev),
             depth=izero, pix=izero,
             base=torch.zeros((), dtype=torch.int64, device=dev),
             nrays=torch.zeros((), dtype=torch.int64, device=dev))
    if k["with_time"]:
        c["time"] = torch.zeros(shape, dtype=torch.float32, device=dev)

    def wave(c):
        # pop work units for idle lanes
        dead = ~c["alive"]
        deadf = dead.reshape(-1).to(torch.int64)
        offs = (torch.cumsum(deadf, 0) - deadf).reshape(dead.shape)
        sid = c["base"] + offs
        assign = dead & (sid < total)
        s_idx = sid // npix
        pix = torch.where(assign, sid - s_idx * npix, c["pix"])
        c["pix"] = pix
        c["base"] = torch.clamp_max(c["base"] + deadf.sum(), total)
        pxl = pix % width
        pyl = pix // width + y0
        fresh = (rngmod.seed_pixels(pxl, pyl, cam.width, scene.seed)
                 ^ ((s_idx * SLOT_SEED_MIX) & rngmod.MASK32))
        state = torch.where(assign, fresh, c["state"])
        jxu, state = rngmod.draw(state, assign)
        jyu, state = rngmod.draw(state, assign)
        sf = s_idx.to(torch.float32)
        jx = (sf + jxu) / spp_t
        jy = (sf + jyu) / spp_t
        cro, crd, state = camera_rays(cam, pxl, pyl, jx, jy, state, assign,
                                      cfg.aperture > 0)
        ut = None
        if k["with_time"]:
            ut, state = rngmod.draw(state, assign)
        _start(c, assign, cro, crd, state, k, ut)
        died, lc = _segment(scene, cfg, c, k, walk)
        # bank completed samples (deterministic scatter-add, lane order)
        zero = torch.zeros_like(lc.x)
        vals = torch.stack([torch.where(died, v, zero) for v in lc], dim=-1)
        c["accum_q"].index_put_((c["pix"].reshape(-1),), vals.reshape(-1, 3),
                                accumulate=True)

    # phase 1: full pool while work remains or too many survivors
    cap_rows = max(shape[0] // 16, 1)
    cap = cap_rows * shape[1]
    while bool((c["base"] < total) | (c["alive"].sum() > cap)):
        wave(c)

    # compaction: survivors to the front, then drain the small pool
    _, small, _ = _compact(c, c["alive"], cap_rows, shape[1], {})
    while bool(small["alive"].any()):
        wave(small)
    return small["accum_q"], small["nrays"]
