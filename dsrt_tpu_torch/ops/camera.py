"""Pinhole camera (port of dsrt_tpu/ops/camera.py).

`make_camera` is the reference's host-side float32 camera setup
verbatim; `generate_rays` is the jittered raygen u = (px+jx)/(W-1),
v = (py+jy)/(H-1), dir = lower_left + u*horizontal + v*vertical - origin.
The thin-lens path (aperture > 0) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from dsrt_tpu_torch.ops.linalg import V3


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor       # f32[3]
    lower_left: torch.Tensor   # f32[3]
    horizontal: torch.Tensor   # f32[3]
    vertical: torch.Tensor     # f32[3]
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    lens_radius: torch.Tensor  # f32[]
    width: int
    height: int

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def vector(self) -> np.ndarray:
        """[origin, lower_left, horizontal, vertical] as f32[12] (the
        kernel's camera argument)."""
        return np.concatenate([self.origin.cpu().numpy(),
                               self.lower_left.cpu().numpy(),
                               self.horizontal.cpu().numpy(),
                               self.vertical.cpu().numpy()]).astype(
                                   np.float32)


def make_camera(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov: float = 40.0,
                width: int = 800, height: int = 450, aperture: float = 0.0,
                focus_dist: float | None = None, device="cpu") -> Camera:
    if aperture > 0:
        raise NotImplementedError(
            "thin-lens camera (aperture > 0): ROADMAP queue 2 item 7")
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

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(origin=t(origin), lower_left=t(lower_left),
                  horizontal=t(horizontal), vertical=t(vertical),
                  u=t(u), v=t(v), w=t(w),
                  lens_radius=t(np.float32(aperture * 0.5)),
                  width=int(width), height=int(height))


def point_camera_at(cam_pos, target=(0.0, 0.0, 0.0), **kw) -> Camera:
    """Look at `target` with vup=(0,1,0), focus at the target distance."""
    return make_camera(cam_pos, target, vup=(0.0, 1.0, 0.0), **kw)


def camera_from_reference(ref, device="cpu") -> Camera:
    """Camera from any object with the reference Camera's fields (values
    read with np.asarray, so a JAX camera converts without importing JAX
    here)."""
    def t(name):
        return torch.as_tensor(np.array(getattr(ref, name), np.float32),
                               device=device)
    if float(np.asarray(ref.lens_radius)) > 0:
        raise NotImplementedError(
            "thin-lens camera (aperture > 0): ROADMAP queue 2 item 7")
    return Camera(origin=t("origin"), lower_left=t("lower_left"),
                  horizontal=t("horizontal"), vertical=t("vertical"),
                  u=t("u"), v=t("v"), w=t("w"),
                  lens_radius=t("lens_radius"),
                  width=int(ref.width), height=int(ref.height))


def generate_rays(cam: Camera, px, py, jx, jy) -> Tuple[V3, V3]:
    """Jittered pinhole raygen over same-shaped px/py (int) and jx/jy
    (float32) tensors; returns (origin, direction)."""
    dev = jx.device
    # divide by device tensors: a CUDA division by a host scalar becomes a
    # reciprocal multiply, which differs in the last bit
    wm1 = torch.tensor(cam.width - 1, dtype=torch.float32, device=dev)
    hm1 = torch.tensor(cam.height - 1, dtype=torch.float32, device=dev)
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
