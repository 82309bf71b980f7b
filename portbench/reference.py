"""Plain PyTorch reference of the rendezvous frames' pixels.

Given the benchmark's own inputs (the stand-in mesh of portbench/standin.py,
the texture image, a pose line, the frame's size, spp, seed and dispatch
budget), it works out again everything the program derives from them:

- the camera and the sun vector of the pose (portbench/poses.py `frame_of`,
  then the float32 camera set-up);
- the scene tables the program's compiler makes from the mesh: the
  triangles' edges, face normals, anchored and bf16-rounded UVs, the
  materials with textured albedo forced white, and the bf16-rounded linear
  texture pool;
- every sample of the pixels asked for, over every salted chunk launch of
  the frame, with the program's per-pixel LCG stream;
- the tonemap to u8.

The closest hit is a brute-force search over all triangles (the nearest t,
ties to the larger triangle index), pruned only by conservative boxes over
runs of 32 consecutive triangles; it shares nothing with the program's
SBVH.  The arithmetic of the sample path is a frozen copy, cut to the
stand-in's materials (lambertian, textured lambertian, metal), of
dsrt_tpu_torch/ops/shade.py (`bounce_step`, `trace_paths`,
`render_samples`, commit 20075d2), ops/trace.py (`_leaf_scan`,
`hit_from_kernel`, commit 184e94f), ops/rng.py (commit b68685b),
ops/linalg.py and ops/camera.py (`make_camera`, `generate_rays`, commit
f0b5744), ops/textures.py `sample_image` (commit f0b5744),
models/scene.py `SceneBuilder.build` (commit 92c3b0f) and render.py
(`fused_chunk_spp`, `render_accum_fused`, `tonemap_u8`, commit 20075d2).
Every float expression keeps that order of operations, so on a sound
program the pixels agree bit for bit but where two triangles tie.

`dtype` torch.bfloat16 computes the same in bfloat16: the check's
control.  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench import poses as posemod
from portbench.standin import LAMBERTIAN, METAL

LCG_A = 1664525
LCG_C = 1013904223
MASK32 = 0xFFFFFFFF
MANT = 0x00FFFFFF
INV_2_24 = float(np.float32(1.0 / 16777216.0))
PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2.0) * np.float32(np.pi))
SALT_MIX = 0x9E3779B9
CLUSTER = 32
BOX_PAD = 1e-2


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)


def _dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def _cross(a, b):
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def _vwhere(m, a, b):
    return V3(*(torch.where(m, p, q) for p, q in zip(a, b)))


class Ctx:
    """Device, float type and the cached constants of one reference run."""

    def __init__(self, device, dtype=torch.float32):
        self.dev = torch.device(device)
        self.dt = dtype
        self._c = {}

    def c(self, value) -> torch.Tensor:
        """A 0-dim constant in the run's float type (divisions by a host
        scalar would become reciprocal multiplies on the card)."""
        if value not in self._c:
            self._c[value] = torch.tensor(float(value), dtype=self.dt,
                                          device=self.dev)
        return self._c[value]

    def f64(self, fn, x, *args):
        return fn(x.double(), *args).to(self.dt)

    def sqrt(self, x):
        return self.f64(torch.sqrt, x)

    def normalize(self, a: V3) -> V3:
        l2 = _dot(a, a)
        inv = torch.where(l2 > 0.0,
                          1.0 / self.sqrt(torch.clamp_min(l2, 1e-38)),
                          torch.zeros_like(l2))
        return a * inv


def bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                            & np.uint32(1)))
               & np.uint32(0xFFFF0000)).astype(np.uint32)
    return rounded.view(np.float32).reshape(a.shape)


class Tables:
    """The scene tables of the stand-in, worked out from the mesh."""

    def __init__(self, mesh, texture_rgb8: np.ndarray, ctx: Ctx):
        v0 = np.asarray(mesh.v0, np.float32)
        v1 = np.asarray(mesh.v1, np.float32)
        v2 = np.asarray(mesh.v2, np.float32)
        fn = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = np.where(ln > 0, fn / np.maximum(ln, 1e-30),
                      0.0).astype(np.float32)
        tex = np.asarray([0 if p else -1 for p in mesh.tex_paths], np.int32)
        uv0, uv1, uv2 = (np.asarray(u, np.float32)
                         for u in (mesh.uv0, mesh.uv1, mesh.uv2))
        if (tex >= 0).any():
            anchor = np.floor(uv0) * (tex >= 0)[:, None]
            uv0, uv1, uv2 = (bf16_round(uv0 - anchor), bf16_round(uv1 - anchor),
                             bf16_round(uv2 - anchor))
        kind = np.asarray([m.kind for m in mesh.materials], np.float32)
        white = {id(m) for m, p in zip(mesh.materials, mesh.tex_paths) if p}
        albedo = np.asarray([(1.0, 1.0, 1.0) if id(m) in white else m.albedo
                             for m in mesh.materials], np.float32)
        fuzz = np.asarray([m.fuzz for m in mesh.materials], np.float32)
        self.n = len(v0)

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=ctx.dev).to(dtype or ctx.dt)

        self.v0, self.e1, self.e2 = t(v0), t(v1 - v0), t(v2 - v0)
        self.fn = t(fn)
        self.uv = t(np.concatenate([uv0, uv1, uv2], axis=1))
        self.kind = t(kind, torch.int64)
        self.albedo = t(albedo)
        self.fuzz = t(fuzz)
        self.tex = t(tex, torch.int64)
        linear = np.power(texture_rgb8.astype(np.float32) / 255.0, 2.2)
        self.tex_h, self.tex_w = texture_rgb8.shape[:2]
        self.pool = t(bf16_round(linear.reshape(-1).astype(np.float32)))

        # conservative boxes over runs of CLUSTER consecutive triangles
        nc = -(-self.n // CLUSTER)
        pad = np.full((nc * CLUSTER - self.n, 3), np.nan, np.float32)
        allv = np.stack([np.concatenate([v, pad]) for v in (v0, v1, v2)], 1)
        allv = allv.reshape(nc, CLUSTER * 3, 3)
        lo, hi = np.nanmin(allv, axis=1), np.nanmax(allv, axis=1)
        self.box_lo = t(lo - (BOX_PAD + 1e-5 * np.abs(lo)), torch.float32)
        self.box_hi = t(hi + (BOX_PAD + 1e-5 * np.abs(hi)), torch.float32)


def camera(cam_pos: np.ndarray, vfov: float, width: int, height: int):
    """(origin, lower_left, horizontal, vertical), float32, of the camera
    at `cam_pos` looking at the origin with vup +y."""
    lookfrom = np.asarray(cam_pos, np.float32)
    lookat = np.zeros(3, np.float32)
    vup = np.asarray((0.0, 1.0, 0.0), np.float32)
    focus = float(np.linalg.norm(lookfrom - lookat))
    aspect = np.float32(width) / np.float32(height)
    theta = np.float32(math.radians(vfov))
    h = np.float32(np.tan(theta / 2.0, dtype=np.float32))
    vh = np.float32(2.0) * h
    vw = aspect * vh

    def unit(x):
        return (x / np.linalg.norm(x)).astype(np.float32)

    w = unit(lookfrom - lookat)
    u = unit(np.cross(vup, w))
    v = np.cross(w, u).astype(np.float32)
    hz = (np.float32(focus) * vw * u).astype(np.float32)
    vt = (np.float32(focus) * vh * v).astype(np.float32)
    ll = (lookfrom - hz * np.float32(0.5) - vt * np.float32(0.5)
          - np.float32(focus) * w).astype(np.float32)
    return lookfrom, ll, hz, vt


def sun_ldir(sun_dir_model: np.ndarray) -> np.ndarray:
    """Ldir = normalize(-sun_dir) in float32, the square root in float64."""
    sd = torch.as_tensor(np.asarray(sun_dir_model, np.float32))
    x, y, z = -sd[0], -sd[1], -sd[2]
    l2 = x * x + y * y + z * z
    inv = torch.where(l2 > 0.0,
                      1.0 / torch.sqrt(torch.clamp_min(l2, 1e-38).double()
                                       ).float(), torch.zeros_like(l2))
    return np.array([float(x * inv), float(y * inv), float(z * inv)],
                    np.float32)


def chunk_schedule(width: int, height: int, spp: int, budget: int):
    """[(spp of the launch, salt)] of a frame: one launch, or chunks of
    budget // (width * height) samples salted i * 0x9E3779B9."""
    per = width * height
    if budget <= 0 or per * spp <= budget:
        return [(spp, 0)]
    chunk = max(1, budget // per)
    out, done, i = [], 0, 0
    while done < spp:
        c = min(chunk, spp - done)
        out.append((c, (i * SALT_MIX) & MASK32))
        done += c
        i += 1
    return out


class Lanes(NamedTuple):
    """One (frame, pixel, launch) per lane."""
    px: torch.Tensor        # int64
    py: torch.Tensor
    state: torch.Tensor     # int64 LCG state
    spp: torch.Tensor       # int64 samples of the lane's launch
    cam: tuple              # origin, lower_left, horizontal, vertical: V3
    sdir: V3


def make_lanes(ctx: Ctx, frames: list, width: int, height: int,
               seed: int) -> Lanes:
    """`frames`: [(pose line, vfov, [(px, py)], [(spp, salt)])]."""
    cols = {k: [] for k in ("px", "py", "spp", "salt", "cam", "sun")}
    for line, vfov, pixels, launches in frames:
        cam_pos, sun_dir, _ = posemod.frame_of(line)
        cam = np.concatenate(camera(cam_pos, vfov, width, height))
        ld = sun_ldir(sun_dir)
        for spp, salt in launches:
            for x, y in pixels:
                cols["px"].append(x)
                cols["py"].append(y)
                cols["spp"].append(spp)
                cols["salt"].append(salt)
                cols["cam"].append(cam)
                cols["sun"].append(ld)
    dev = ctx.dev
    px = torch.as_tensor(cols["px"], dtype=torch.int64, device=dev)
    py = torch.as_tensor(cols["py"], dtype=torch.int64, device=dev)
    salt = torch.as_tensor(cols["salt"], dtype=torch.int64, device=dev)
    state = ((px + py * int(width)) & MASK32) ^ ((int(seed) ^ salt) & MASK32)
    cam = torch.as_tensor(np.asarray(cols["cam"], np.float32),
                          device=dev).to(ctx.dt)
    sun = torch.as_tensor(np.asarray(cols["sun"], np.float32),
                          device=dev).to(ctx.dt)
    vecs = tuple(V3(cam[:, 3 * k], cam[:, 3 * k + 1], cam[:, 3 * k + 2])
                 for k in range(4))
    return Lanes(px, py, state,
                 torch.as_tensor(cols["spp"], dtype=torch.int64, device=dev),
                 vecs, V3(sun[:, 0], sun[:, 1], sun[:, 2]))


def _draw(ctx: Ctx, state, mask):
    ns = (state * LCG_A + LCG_C) & MASK32
    ns = torch.where(mask, ns, state)
    return (ns & MANT).to(ctx.dt) * INV_2_24, ns


def _in_unit_sphere(ctx: Ctx, state, mask, max_tries: int = 64):
    def attempt(state, need):
        x, state = _draw(ctx, state, need)
        y, state = _draw(ctx, state, need)
        z, state = _draw(ctx, state, need)
        return V3(x * 2.0 - 1.0, y * 2.0 - 1.0, z * 2.0 - 1.0), state

    def outside(p):
        return p.x * p.x + p.y * p.y + p.z * p.z >= 1.0

    p, state = attempt(state, mask)
    need = mask & outside(p)
    for _ in range(max_tries):
        if not bool(need.any()):
            break
        cand, state = attempt(state, need)
        p = _vwhere(need, cand, p)
        need = need & outside(cand)
    return p, state


class Hit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    n: V3
    tri: torch.Tensor
    tu: torch.Tensor
    tv: torch.Tensor


def _pairs(tb: Tables, o: V3, d: V3, t_min: float, t_max: float):
    """(ray, triangle) pairs whose triangle lies in a box the ray meets."""
    of = [c.float() for c in o]
    inv = [1.0 / c.float() for c in d]
    n = of[0].shape[0]
    tn = torch.full((n, tb.box_lo.shape[0]), t_min, device=of[0].device)
    tf = torch.full_like(tn, t_max)
    for a in range(3):
        t0 = (tb.box_lo[None, :, a] - of[a][:, None]) * inv[a][:, None]
        t1 = (tb.box_hi[None, :, a] - of[a][:, None]) * inv[a][:, None]
        near = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf)
        far = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf)
        tn = torch.maximum(tn, near)
        tf = torch.minimum(tf, far)
    r, c = torch.nonzero(tn <= tf, as_tuple=True)
    k = torch.arange(CLUSTER, device=r.device)
    tri = (c[:, None] * CLUSTER + k[None, :]).reshape(-1)
    ray = r[:, None].expand(-1, CLUSTER).reshape(-1)
    keep = tri < tb.n
    return ray[keep], tri[keep]


def _intersect(ctx: Ctx, tb: Tables, o: V3, d: V3, active, any_hit: bool):
    """Closest (or any) triangle hit of the active rays in
    [hit_eps, hit_tmax]: (hit, t, u, v, tri) per ray."""
    n = o.x.shape[0]
    dev = o.x.device
    t_min, t_max = ctx.c(1e-3), ctx.c(1e9)
    idx = torch.nonzero(active).reshape(-1)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros(n, dtype=ctx.dt, device=dev)
    win = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if idx.numel() == 0:
        return hit, zero + t_max, zero, zero, win
    sub_o = V3(*(c[idx] for c in o))
    sub_d = V3(*(c[idx] for c in d))
    ray, tri = _pairs(tb, sub_o, sub_d, float(t_min), float(t_max))
    ox, oy, oz = (c[ray] for c in sub_o)
    dx, dy, dz = (c[ray] for c in sub_d)
    e1x, e1y, e1z = tb.e1[tri, 0], tb.e1[tri, 1], tb.e1[tri, 2]
    e2x, e2y, e2z = tb.e2[tri, 0], tb.e2[tri, 1], tb.e2[tri, 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvx = ox - tb.v0[tri, 0]
    tvy = oy - tb.v0[tri, 1]
    tvz = oz - tb.v0[tri, 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok & (t >= t_min) & (t <= t_max)
    m = idx.numel()
    if any_hit:
        got = torch.zeros(m, dtype=torch.bool, device=dev)
        got[ray[ok]] = True
        hit[idx] = got
        return hit, zero, zero, zero, win
    tf = torch.where(ok, t.float(), torch.full_like(t, math.inf,
                                                    dtype=torch.float32))
    best = torch.full((m,), math.inf, device=dev).scatter_reduce(
        0, ray, tf, "amin")
    cand = ok & (tf == best[ray])
    top = torch.full((m,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, ray[cand], tri[cand], "amax")
    sel = cand & (tri == top[ray])
    rows = idx[ray[sel]]
    hit[rows] = True
    win[rows] = tri[sel]
    tt = torch.full((n,), float(t_max), dtype=ctx.dt, device=dev)
    uu, vv = zero.clone(), zero.clone()
    tt[rows], uu[rows], vv[rows] = t[sel], u[sel], v[sel]
    return hit, tt, uu, vv, win


def scene_hit(ctx: Ctx, tb: Tables, o: V3, d: V3, active) -> Hit:
    hm, t, u, v, tri = _intersect(ctx, tb, o, d, active, False)
    trc = torch.clamp(tri, 0, tb.n - 1)
    fn = tb.fn[trc]
    uv = tb.uv[trc]
    w = 1.0 - u - v
    tu = w * uv[:, 0] + u * uv[:, 2] + v * uv[:, 4]
    tv = w * uv[:, 1] + u * uv[:, 3] + v * uv[:, 5]
    nx, ny, nz = fn[:, 0], fn[:, 1], fn[:, 2]
    front = (d.x * nx + d.y * ny + d.z * nz) < 0.0
    sgn = torch.where(front, 1.0, -1.0).to(ctx.dt)
    zero = torch.zeros_like(t)
    n = V3(torch.where(hm, sgn * nx, zero), torch.where(hm, sgn * ny, zero),
           torch.where(hm, sgn * nz, zero))
    return Hit(hm, t, n, tri, torch.where(hm, tu, zero),
               torch.where(hm, tv, zero))


def _texel(ctx: Ctx, tb: Tables, hit: Hit):
    uu = hit.tu - torch.floor(hit.tu)
    vv = hit.tv - torch.floor(hit.tv)
    i = (uu * ctx.c(tb.tex_w - 1)).to(torch.int64)
    j = ((1.0 - vv) * ctx.c(tb.tex_h - 1)).to(torch.int64)
    idx = (j * tb.tex_w + i) * 3
    pool_n = tb.pool.shape[0]
    tid = tb.tex[torch.clamp(hit.tri, 0, tb.n - 1)]
    ok = (tid >= 0) & (idx >= 0) & (idx + 2 < pool_n)
    idx = torch.clamp(idx, 0, pool_n - 3)
    one = torch.ones_like(hit.tu)
    return V3(*(torch.where(ok, tb.pool[idx + c], one) for c in range(3)))


def _bounce(ctx: Ctx, tb: Tables, cfg: dict, L, thr, ro, rd, state, alive,
            rr_mask, sdir: V3):
    one = torch.ones_like(ro.x)
    pi = ctx.c(PI_F)

    u_rr, state = _draw(ctx, state, rr_mask)
    p_rr = torch.clamp_max(torch.maximum(thr.x, torch.maximum(thr.y, thr.z)),
                           float(cfg["rr_max_p"]))
    killed = rr_mask & (u_rr > p_rr)
    alive = alive & ~killed
    inv_p = 1.0 / torch.where(p_rr > 0, p_rr, one)
    thr = _vwhere(rr_mask & ~killed, thr * inv_p, thr)

    hit = scene_hit(ctx, tb, ro, rd, alive)
    alive = alive & hit.hit
    n = hit.n
    p = V3(ro.x + hit.t * rd.x, ro.y + hit.t * rd.y, ro.z + hit.t * rd.z)
    surf = alive
    trc = torch.clamp(hit.tri, 0, tb.n - 1)
    mtype = tb.kind[trc]
    alb = tb.albedo[trc]
    albedo = V3(alb[:, 0], alb[:, 1], alb[:, 2])
    tex_rgb = _texel(ctx, tb, hit)
    albedo = _vwhere(surf & (tb.tex[trc] >= 0), albedo * tex_rgb, albedo)

    metal = surf & (mtype == METAL)
    unit_in = ctx.normalize(rd)
    refl = unit_in - n * (2.0 * _dot(unit_in, n))
    fuzz = torch.clamp(tb.fuzz[trc], 0.0, 1.0)
    fz, state = _in_unit_sphere(ctx, state, metal)
    metal_dir = refl + fz * fuzz
    alive = alive & ~(metal & ~(_dot(metal_dir, n) > 0.0))
    thr = _vwhere(metal & alive, thr * albedo, thr)
    ro = _vwhere(metal & alive, p, ro)
    rd = _vwhere(metal & alive, metal_dir, rd)

    diff = surf & (mtype == LAMBERTIAN) & alive
    cos_sun = torch.clamp_min(_dot(n, sdir), 0.0)
    pot = diff & (cos_sun > 0.0)
    bias = float(cfg["shadow_bias"])
    sh_o = V3(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z)
    blocked = _intersect(ctx, tb, sh_o, sdir, pot, True)[0]
    pdf_s = cos_sun / pi
    w_sun = pdf_s / (0.5 + 0.5 * pdf_s)
    rad = V3(*(ctx.c(r).expand(p.x.shape) for r in cfg["sun_radiance"]))
    L = _vwhere(pot & ~blocked, L + thr * albedo * rad * w_sun, L)

    r1, state = _draw(ctx, state, diff)
    r2, state = _draw(ctx, state, diff)
    z = ctx.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = TWO_PI_F * r1
    sq = ctx.sqrt(torch.clamp_min(r2, 0.0))
    local = V3(ctx.f64(torch.cos, phi) * sq, ctx.f64(torch.sin, phi) * sq, z)
    w = ctx.normalize(n)
    big = torch.abs(w.x) > 0.9
    zero, onev = torch.zeros_like(w.x), torch.ones_like(w.x)
    a = V3(torch.where(big, zero, onev), torch.where(big, onev, zero), zero)
    vb = ctx.normalize(_cross(w, a))
    ub = _cross(vb, w)
    world = ctx.normalize(ub * local.x + vb * local.y + w * local.z)
    cos_t = torch.clamp_min(_dot(world, n), 0.0)
    pdf = torch.where(cos_t > 0.0, cos_t / pi, torch.zeros_like(cos_t))
    ok = pdf > 0.0
    alive = alive & ~(diff & ~ok)
    move = diff & ok
    thr = _vwhere(move, thr * albedo, thr)
    ro = _vwhere(move, p, ro)
    rd = _vwhere(move, world, rd)
    return L, thr, ro, rd, state, alive


def render_lanes(ctx: Ctx, tb: Tables, lanes: Lanes, width: int, height: int,
                 cfg: dict) -> torch.Tensor:
    """(n, 3) sums of clamp01(L) over each lane's samples."""
    px, py, state = lanes.px, lanes.py, lanes.state
    o, ll, hz, vt = lanes.cam
    spp_f = lanes.spp.to(ctx.dt)
    zero = torch.zeros(px.shape, dtype=ctx.dt, device=ctx.dev)
    acc = V3(zero, zero, zero)
    wm1, hm1 = ctx.c(width - 1), ctx.c(height - 1)
    pxf, pyf = px.to(ctx.dt), py.to(ctx.dt)
    for s in range(int(lanes.spp.max())):
        valid = lanes.spp > s
        jxu, state = _draw(ctx, state, valid)
        jyu, state = _draw(ctx, state, valid)
        sf = ctx.c(s)
        jx = (sf + jxu) / spp_f
        jy = (sf + jyu) / spp_f
        u = (pxf + jx) / wm1
        v = (pyf + jy) / hm1
        rd = V3(ll.x + u * hz.x + v * vt.x - o.x,
                ll.y + u * hz.y + v * vt.y - o.y,
                ll.z + u * hz.z + v * vt.z - o.z)
        ro = o
        L, thr = V3(zero, zero, zero), V3(zero + 1, zero + 1, zero + 1)
        alive = valid
        for depth in range(int(cfg["max_depth"])):
            if not bool(alive.any()):
                break
            rr = alive & (depth >= int(cfg["rr_start_depth"]))
            L, thr, ro, rd, state, alive = _bounce(
                ctx, tb, cfg, L, thr, ro, rd, state, alive, rr, lanes.sdir)
        acc = acc + V3(*(torch.clamp(c, 0.0, 1.0) for c in L))
    return torch.stack(list(acc), dim=-1)


def tonemap_u8(accum: torch.Tensor, spp: int, gamma: float,
               firefly: float) -> torch.Tensor:
    inv_spp = float(np.float32(1.0 / spp))
    inv_gamma = float(np.float32(1.0 / gamma))
    c = accum * inv_spp
    c = torch.clamp_min(c, 0.0)
    c = torch.clamp_max(c, float(firefly))
    c = torch.pow(c.double(), inv_gamma).to(accum.dtype)
    c = torch.clamp(c, 0.0, 1.0)
    return (255.99 * c).to(torch.uint8)


def render_pixels(ctx: Ctx, tb: Tables, frames: list, width: int,
                  height: int, spp: int, seed: int, budget: int,
                  cfg: dict, lane_block: int = 1 << 14):
    """u8 (n, 3) of the listed pixels of each frame, every launch of the
    frame's chunk schedule, in frame then pixel order.  `frames`:
    [(pose line, vfov, [(px, py)])]; lanes run in blocks of whole
    frames so that a block stays under `lane_block` lanes."""
    sched = chunk_schedule(width, height, spp, budget)
    out = []
    block = []

    def flush():
        if not block:
            return
        lanes = make_lanes(ctx, [f + (sched,) for f in block], width,
                           height, seed)
        sums = render_lanes(ctx, tb, lanes, width, height, cfg)
        start = 0
        for f in block:
            npx = len(f[2])
            per = sums[start:start + npx * len(sched)].reshape(
                len(sched), npx, 3)
            start += npx * len(sched)
            total = per[0]
            for k in range(1, len(sched)):
                total = total + per[k]
            out.append(tonemap_u8(total, spp, cfg["gamma"],
                                  cfg["firefly_clamp"]).cpu())
        block.clear()

    for f in frames:
        if block and (sum(len(b[2]) for b in block) + len(f[2])) * len(
                sched) > lane_block:
            flush()
        block.append(f)
    flush()
    return out


def radiance_probe(ctx: Ctx, tb: Tables, frames: list, width: int,
                   height: int, seed: int, cfg: dict, spp: int = 8,
                   lane_block: int = 1 << 15):
    """Mean radiance (n, 3) of each listed pixel over `spp` samples of the
    unsalted stream: the check's look for pixels worth judging.  Frames
    run in blocks of at most `lane_block` lanes (a frame alone may pass
    it)."""
    out, block = [], []

    def flush():
        if block:
            lanes = make_lanes(ctx, [f + ([(spp, 0)],) for f in block],
                               width, height, seed)
            out.append(render_lanes(ctx, tb, lanes, width, height, cfg)
                       .float().cpu() / spp)
            block.clear()

    for f in frames:
        if block and sum(len(b[2]) for b in block) + len(f[2]) > lane_block:
            flush()
        block.append(f)
    flush()
    return torch.cat(out) if out else torch.zeros((0, 3))
