"""Texture evaluation (port of dsrt_tpu/ops/textures.py).

- `sample_image`: nearest-neighbour fetch from the flat RGB pool: wrap
  u, v to [0, 1) by floor-frac, V-flip j = (1 - v)(h - 1), truncating
  float->int texel index, white on an invalid id or an out-of-range
  index (idx + 2 must be below the pool length).
- `sample_env`: the equirectangular sky, u = atan2(z, x)/2pi + 0.5 + rot,
  v from acos(y), through the reference's polynomial `atan2f`/`acosf`
  (not the library functions), then `sample_image`.
- `perlin_noise`/`perlin_turb`/`sample_procedural`: checker, marble and
  noise albedo over the hash-gradient Perlin.  The hash is uint32
  arithmetic; PyTorch's CPU build has none, so it rides in int64 masked
  to 32 bits, and products are split so that they never overflow.

Every division by a constant divides by a device tensor (CUDA turns a
division by a host scalar into a reciprocal multiply), and every float
constant is a float32 value, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsrt_tpu.models.materials import PTEX_CHECKER, PTEX_MARBLE, PTEX_NOISE
from dsrt_tpu_torch.ops.linalg import V3, f64_op, sqrt
from dsrt_tpu_torch.ops.rng import PI_F, TWO_PI_F

MASK32 = 0xFFFFFFFF
ATAN_C = tuple(float(np.float32(c)) for c in (
    0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332,
    -0.01172120))
HALF_PI_F = float(np.float32(0.5 * math.pi))
ENV_V_MAX = float(np.float32(1.0 - 1e-6))
HASH_MUL = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
HASH_MIX = 0x27D4EB2F


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on `like`'s device (a divisor)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=like.device)


def sample_image(scene, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> V3:
    valid = (tex_id >= 0) & (tex_id < scene.n_textures)
    tid = torch.clamp(tex_id, 0, max(scene.n_textures - 1, 0)).to(
        torch.int64)
    w = scene.tex_w[tid].to(torch.int64)
    h = scene.tex_h[tid].to(torch.int64)
    off = scene.tex_off[tid].to(torch.int64)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    i = (uu * (w - 1).to(torch.float32)).to(torch.int64)
    j = ((1.0 - vv) * (h - 1).to(torch.float32)).to(torch.int64)
    idx = off + (j * w + i) * 3
    pool_n = scene.tex_pool.shape[0]
    ok = valid & (idx >= 0) & (idx + 2 < pool_n)
    idx = torch.clamp(idx, 0, pool_n - 3)
    one = torch.ones_like(u)
    return V3(*(torch.where(ok, scene.tex_pool[idx + c], one)
                for c in range(3)))


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 from an odd minimax polynomial of atan on [0, 1] and a
    quadrant fix-up (|err| < 3e-7)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    t = mn / torch.clamp_min(mx, 1e-30)
    s = t * t
    c = ATAN_C
    p = c[0] + s * (c[1] + s * (c[2] + s * (c[3] + s * (c[4] + s * c[5]))))
    p = t * p
    r = torch.where(ay > ax, HALF_PI_F - p, p)
    r = torch.where(x < 0, PI_F - r, r)
    return torch.where(y < 0, -r, r)


def acosf(x: torch.Tensor) -> torch.Tensor:
    """acos(x) = atan2(sqrt(1 - x^2), x)."""
    return atan2f(sqrt(torch.clamp_min(1.0 - x * x, 0.0)), x)


def sample_env(scene, d: V3) -> V3:
    """Sky radiance for (not necessarily unit) directions `d`."""
    inv_len = 1.0 / sqrt(torch.clamp_min(d.x * d.x + d.y * d.y + d.z * d.z,
                                         1e-20))
    rot = float(np.float32(scene.env_rotation / (2.0 * math.pi)))
    u = (atan2f(d.z * inv_len, d.x * inv_len) / _f32(TWO_PI_F, d.x)
         + 0.5 + rot)
    v = 1.0 - acosf(torch.clamp(d.y * inv_len, -1.0, 1.0)) / _f32(PI_F, d.x)
    # a hair inside [0, 1) so the wrap never flips the poles
    v = torch.clamp(v, 0.0, ENV_V_MAX)
    tex = torch.full(u.shape, int(scene.env_tex), dtype=torch.int64,
                     device=u.device)
    rgb = sample_image(scene, tex, u, v)
    return rgb * float(np.float32(scene.env_scale))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), with no int64
    overflow: the high half of c contributes only its low 16 bits."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash3(i: torch.Tensor, j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Integer lattice hash (xorshift-multiply mix) of int64 lattice
    coordinates; returns uint32 values in int64."""
    h = (_mul32(i & MASK32, HASH_MUL[0]) ^ _mul32(j & MASK32, HASH_MUL[1])
         ^ _mul32(k & MASK32, HASH_MUL[2]))
    h = h ^ (h >> 13)
    h = _mul32(h, HASH_MIX)
    return h ^ (h >> 16)


def grad_dot(h: torch.Tensor, x, y, z) -> torch.Tensor:
    """Dot product with one of improved noise's 12 edge gradients,
    picked by the low 4 bits of the hash."""
    hh = h & 15
    u = torch.where(hh < 8, x, y)
    v = torch.where(hh < 4, y, torch.where((hh == 12) | (hh == 14), x, z))
    return (torch.where((hh & 1) == 0, u, -u)
            + torch.where((hh & 2) == 0, v, -v))


def perlin_noise(p: V3) -> torch.Tensor:
    """Gradient Perlin with Hermite-smoothed trilinear interpolation."""
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    u, v, w = p.x - fx, p.y - fy, p.z - fz
    i, j, k = (c.to(torch.int64) for c in (fx, fy, fz))
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    accum = torch.zeros_like(u)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                h = hash3(i + di, j + dj, k + dk)
                dotv = grad_dot(h, u - di, v - dj, w - dk)
                wt = ((uu if di else 1.0 - uu) * (vv if dj else 1.0 - vv)
                      * (ww if dk else 1.0 - ww))
                accum = accum + wt * dotv
    return accum * 0.5


def perlin_turb(p: V3, depth: int = 7) -> torch.Tensor:
    """|fbm| over `depth` octaves."""
    accum = torch.zeros_like(p.x)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * perlin_noise(q)
        weight *= 0.5
        q = V3(q.x * 2.0, q.y * 2.0, q.z * 2.0)
    return torch.abs(accum)


def sample_procedural(scene, mat_id: torch.Tensor, base: V3, p: V3,
                      mask: torch.Tensor | None = None) -> V3:
    """Albedo after the material's procedural texture at world point p:
    checker = sin(s x) sin(s y) sin(s z) < 0 ? color2 : base; marble =
    0.5 (1 + sin(s z + 10 turb)); noise = clamp01(turb).  Turbulence is
    evaluated only on `mask` lanes whose material needs it."""
    if not scene.has_ptex:
        return base
    mp = scene.mat_pack[mat_id]
    kind = mp[..., 9].to(torch.int64)
    scale = mp[..., 10]
    sines = (f64_op(torch.sin, scale * p.x) * f64_op(torch.sin, scale * p.y)
             * f64_op(torch.sin, scale * p.z))
    odd = sines < 0
    checker = V3(torch.where(odd, mp[..., 11], base.x),
                 torch.where(odd, mp[..., 12], base.y),
                 torch.where(odd, mp[..., 13], base.z))
    need = (kind == PTEX_NOISE) | (kind == PTEX_MARBLE)
    if mask is not None:
        need = need & mask
    turb = torch.zeros(p.x.numel(), dtype=torch.float32, device=p.x.device)
    idx = torch.nonzero(need.reshape(-1)).reshape(-1)
    if idx.numel():
        turb[idx] = perlin_turb(V3(*(c.reshape(-1)[idx] for c in p)))
    turb = turb.reshape(p.x.shape)
    marble = 0.5 * (1.0 + f64_op(torch.sin, scale * p.z + 10.0 * turb))
    noise = torch.clamp(turb, 0.0, 1.0)
    out = base
    for k, val in ((PTEX_CHECKER, checker), (PTEX_MARBLE, V3(marble, marble,
                                                            marble)),
                   (PTEX_NOISE, V3(noise, noise, noise))):
        sel = kind == k
        out = V3(*(torch.where(sel, a, b) for a, b in zip(val, out)))
    return out
