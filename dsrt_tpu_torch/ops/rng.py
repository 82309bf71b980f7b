"""Per-pixel LCG random streams, bit-compatible with dsrt_tpu/ops/rng.py.

    state = state * 1664525 + 1013904223        (mod 2^32)
    sample = (state & 0xFFFFFF) / 16777216.0    in [0, 1)

seeded per pixel as (x + y*W) ^ seed.  PyTorch's CPU build has no uint32
arithmetic, so the state rides in int64 masked to 32 bits after every
step (the product stays below 2^53).  A *masked* draw advances only the
lanes that would draw in the scalar control flow, so each pixel's stream
equals the one-thread-per-pixel CUDA kernel's.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.ops.linalg import V3, f64_op, sqrt

LCG_A = 1664525
LCG_C = 1013904223
MASK32 = 0xFFFFFFFF
MANT = 0x00FFFFFF
INV_2_24 = float(np.float32(1.0 / 16777216.0))
PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2.0) * np.float32(np.pi))


def seed_pixels(px: torch.Tensor, py: torch.Tensor, width: int, seed: int,
                salt: int = 0) -> torch.Tensor:
    """int64 state ((x + y*W) ^ seed ^ salt) & 0xFFFFFFFF."""
    lin = (px.to(torch.int64) + py.to(torch.int64) * int(width)) & MASK32
    return lin ^ ((int(seed) ^ int(salt)) & MASK32)


def next_state(state: torch.Tensor) -> torch.Tensor:
    return (state * LCG_A + LCG_C) & MASK32


def draw(state: torch.Tensor, mask: torch.Tensor | None = None):
    """Advance masked lanes; returns (u01 float32, new_state)."""
    ns = next_state(state)
    if mask is not None:
        ns = torch.where(mask, ns, state)
    u = (ns & MANT).to(torch.float32) * INV_2_24
    return u, ns


def draw2(state, mask=None):
    u1, state = draw(state, mask)
    u2, state = draw(state, mask)
    return u1, u2, state


def random_cosine_direction(state, mask=None):
    """Cosine-weighted local (z-up) direction; 2 draws."""
    r1, r2, state = draw2(state, mask)
    z = sqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = TWO_PI_F * r1
    sq = sqrt(torch.clamp_min(r2, 0.0))
    return (V3(f64_op(torch.cos, phi) * sq, f64_op(torch.sin, phi) * sq, z),
            state)


def random_in_unit_sphere(state, mask=None, max_tries: int = 64):
    """Rejection-sample the unit ball: one attempt of 3 draws, then up to
    `max_tries` retries on the lanes still outside, each lane drawing
    exactly as often as the scalar loop would."""
    if mask is None:
        mask = torch.ones(state.shape, dtype=torch.bool, device=state.device)

    def attempt(state, need):
        x, state = draw(state, need)
        y, state = draw(state, need)
        z, state = draw(state, need)
        return V3(x * 2.0 - 1.0, y * 2.0 - 1.0, z * 2.0 - 1.0), state

    def outside(p):
        return p.x * p.x + p.y * p.y + p.z * p.z >= 1.0

    p, state = attempt(state, mask)
    need = mask & outside(p)
    for _ in range(max_tries):
        if not bool(need.any()):
            break
        cand, state = attempt(state, need)
        p = V3(*(torch.where(need, c, q) for c, q in zip(cand, p)))
        need = need & outside(cand)
    return p, state
