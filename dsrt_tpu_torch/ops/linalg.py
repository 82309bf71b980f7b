"""Structure-of-arrays 3-vector math over torch tensors.

Port of dsrt_tpu/ops/linalg.py.  A `V3` is three same-shaped float32
tensors; every helper is elementwise and device-agnostic.  The float
expressions are written in the reference's exact operation order and
never fused, so the CUDA kernel (built with `-fmad=false`) reproduces
them bit for bit.

Square roots, cos, sin and pow are evaluated in float64 and rounded once
to float32: PyTorch's CPU float32 kernels for them are not correctly
rounded (they differ from IEEE sqrt in the last bit on about 0.6% of
inputs), and the float64 route gives the same float32 result on the CPU,
on the card and in the CUDA kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        if isinstance(o, V3):  # component-wise
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def const(value, device, dtype=torch.float32) -> torch.Tensor:
    """A cached 0-dim tensor holding `value` on `device`.  Making a CUDA
    tensor from a host value waits for the stream to drain, so code that
    runs once per wave takes its constants from here (never write to
    them)."""
    return _const(float(value) if dtype.is_floating_point else int(value),
                  dtype, str(torch.device(device)))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device."""
    return torch.sqrt(x.double()).float()


def f64_op(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """fn evaluated in float64, rounded once to float32 (cos, sin, pow)."""
    return fn(x.double(), *args).float()


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize(a: V3) -> V3:
    """Zero vector -> zero; reciprocal-multiply form of the reference
    (dsrt_tpu/ops/linalg.py:84-89)."""
    l2 = dot(a, a)
    inv = torch.where(l2 > 0.0,
                      1.0 / sqrt(torch.clamp_min(l2, 1e-38)),
                      torch.zeros_like(l2))
    return a * inv


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def maxc(a: V3) -> torch.Tensor:
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def clamp01(a: V3) -> V3:
    return V3(*(torch.clamp(c, 0.0, 1.0) for c in a))


def reflect(v: V3, n: V3) -> V3:
    """r = v - 2 (v.n) n."""
    return v - n * (2.0 * dot(v, n))


def refract(uv: V3, n: V3, etai_over_etat: torch.Tensor) -> V3:
    """Snell refraction of a unit `uv`; the reference's r_perp + r_par."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_perp = (uv + n * cos_theta) * etai_over_etat
    r_par = n * (-sqrt(torch.abs(1.0 - dot(r_perp, r_perp))))
    return r_perp + r_par


def schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's Fresnel approximation."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * f64_op(torch.pow, 1.0 - cosine, 5.0)
