"""Pinhole and thin-lens camera (port of dsrt_tpu/ops/camera.py).

`make_camera` is the reference's host-side float32 camera setup
verbatim; `generate_rays` is the jittered raygen u = (px+jx)/(W-1),
v = (py+jy)/(H-1), dir = lower_left + u*horizontal + v*vertical - origin.
With an aperture, `generate_rays_dof` offsets origin and direction by
lens_radius times a unit-disk sample (2 draws per rejection attempt,
drawn after the jitter pair) on the camera's (u, v) basis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from dsrt_tpu_torch.device import resolve_device, to_device
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops.linalg import V3, const


@dataclasses.dataclass(frozen=True)
class Camera:
    """The camera's 22 float32 values in one tensor; the fields are views
    of it, and its first 19 floats are the kernels' camera argument."""
    flat: torch.Tensor         # f32[22], laid out as FIELDS
    width: int
    height: int

    origin = property(lambda self: self.flat[0:3])
    lower_left = property(lambda self: self.flat[3:6])
    horizontal = property(lambda self: self.flat[6:9])
    vertical = property(lambda self: self.flat[9:12])
    u = property(lambda self: self.flat[12:15])
    v = property(lambda self: self.flat[15:18])
    lens_radius = property(lambda self: self.flat[18])   # f32[]
    w = property(lambda self: self.flat[19:22])

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, flat=self.flat.to(device))

    def vector(self) -> torch.Tensor:
        """[origin, lower_left, horizontal, vertical, u, v, lens_radius]
        as f32[19] on the camera's device (the kernels' camera argument):
        a view, with no copy."""
        return self.flat[:19]


# the order of the camera's values in Camera.flat
FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
          "lens_radius", "w")


def camera_of(values, width: int, height: int, device) -> Camera:
    """The camera of `values`, FIELDS' arrays in order, sent to `device`
    in one copy (`to_device`: on the card one that does not wait for the
    stream, where a copy a field would each wait for it)."""
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in values])
    return Camera(to_device(flat, device), width=int(width),
                  height=int(height))


def make_camera(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov: float = 40.0,
                width: int = 800, height: int = 450, aperture: float = 0.0,
                focus_dist: float | None = None, device=None) -> Camera:
    """The reference's float32 camera setup; on the card unless `device`
    says otherwise."""
    device = resolve_device(device)
    lookfrom = np.asarray(lookfrom, np.float32)
    lookat = np.asarray(lookat, np.float32)
    vup = np.asarray(vup, np.float32)
    if focus_dist is None:
        focus_dist = float(np.linalg.norm(lookfrom - lookat))

    aspect = np.float32(width) / np.float32(height)
    theta = np.float32(math.radians(vfov))
    h = np.float32(np.tan(theta / 2.0, dtype=np.float32))
    viewport_h = np.float32(2.0) * h
    viewport_w = aspect * viewport_h

    def unit(x):
        return (x / np.linalg.norm(x)).astype(np.float32)

    w = unit(lookfrom - lookat)
    u = unit(np.cross(vup, w))
    v = np.cross(w, u).astype(np.float32)

    origin = lookfrom
    horizontal = (np.float32(focus_dist) * viewport_w * u).astype(np.float32)
    vertical = (np.float32(focus_dist) * viewport_h * v).astype(np.float32)
    lower_left = (origin - horizontal * np.float32(0.5)
                  - vertical * np.float32(0.5)
                  - np.float32(focus_dist) * w).astype(np.float32)

    return camera_of((origin, lower_left, horizontal, vertical, u, v,
                      np.float32(aperture * 0.5), w), width, height, device)


def point_camera_at(cam_pos, target=(0.0, 0.0, 0.0), **kw) -> Camera:
    """Look at `target` with vup=(0,1,0), focus at the target distance."""
    return make_camera(cam_pos, target, vup=(0.0, 1.0, 0.0), **kw)


def camera_from_reference(ref, device=None) -> Camera:
    """Camera from any object with the reference Camera's fields (values
    read with np.asarray, so a JAX camera converts without importing JAX
    here), on the card unless `device` says otherwise."""
    return camera_of([np.array(getattr(ref, name), np.float32)
                      for name in FIELDS], ref.width, ref.height,
                     resolve_device(device))


def generate_rays(cam: Camera, px, py, jx, jy) -> Tuple[V3, V3]:
    """Jittered pinhole raygen over same-shaped px/py (int) and jx/jy
    (float32) tensors; returns (origin, direction)."""
    dev = jx.device
    # divide by device tensors: a CUDA division by a host scalar becomes a
    # reciprocal multiply, which differs in the last bit
    wm1 = const(cam.width - 1, dev)
    hm1 = const(cam.height - 1, dev)
    u = (px.to(torch.float32) + jx) / wm1
    v = (py.to(torch.float32) + jy) / hm1
    o = cam.origin.to(dev)
    ll, hz, vt = (cam.lower_left.to(dev), cam.horizontal.to(dev),
                  cam.vertical.to(dev))
    dx = ll[0] + u * hz[0] + v * vt[0] - o[0]
    dy = ll[1] + u * hz[1] + v * vt[1] - o[1]
    dz = ll[2] + u * hz[2] + v * vt[2] - o[2]
    origin = V3(o[0].expand(u.shape), o[1].expand(u.shape),
                o[2].expand(u.shape))
    return origin, V3(dx, dy, dz)


def random_in_unit_disk(state, mask=None, max_tries: int = 64):
    """Rejection-sample the unit disk: one attempt of 2 draws, then up to
    `max_tries` retries on the lanes still outside."""
    if mask is None:
        mask = torch.ones(state.shape, dtype=torch.bool, device=state.device)

    def attempt(state, need):
        x, state = rngmod.draw(state, need)
        y, state = rngmod.draw(state, need)
        return x * 2.0 - 1.0, y * 2.0 - 1.0, state

    x, y, state = attempt(state, mask)
    need = mask & (x * x + y * y >= 1.0)
    for _ in range(max_tries):
        if not bool(need.any()):
            break
        cx, cy, state = attempt(state, need)
        x = torch.where(need, cx, x)
        y = torch.where(need, cy, y)
        need = need & ~(cx * cx + cy * cy < 1.0)
    return x, y, state


def generate_rays_dof(cam: Camera, px, py, jx, jy, state, mask):
    """Thin-lens jittered raygen; returns (origin, direction, state)."""
    origin0, rd0 = generate_rays(cam, px, py, jx, jy)
    dx, dy, state = random_in_unit_disk(state, mask)
    lr = cam.lens_radius.to(jx.device)
    cu, cv = cam.u.to(jx.device), cam.v.to(jx.device)
    rdx = lr * dx
    rdy = lr * dy
    off = V3(cu[0] * rdx + cv[0] * rdy, cu[1] * rdx + cv[1] * rdy,
             cu[2] * rdx + cv[2] * rdy)
    return origin0 + off, rd0 - off, state


def camera_rays(cam: Camera, px, py, jx, jy, state, mask,
                aperture_on: bool):
    """Pinhole or thin-lens raygen; the state advances only on the
    thin-lens path."""
    if aperture_on:
        return generate_rays_dof(cam, px, py, jx, jy, state, mask)
    ro, rd = generate_rays(cam, px, py, jx, jy)
    return ro, rd, state
