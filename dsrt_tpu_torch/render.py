"""Frame rendering: the sample loop, the salted-chunk schedule, tonemap.

Port of dsrt_tpu/render.py:82-153 (`render_frame`, the parity renderer),
:185-247 (`render_frame_fused`) and :274-338 (the per-dispatch ray budget).

`render_frame` runs the plain PyTorch path tracer on the scene's device.
`render_frame_fused` runs the path kernel on a CUDA scene (and its plain
version on a CPU scene); a frame above FUSED_DISPATCH_RAYS primary rays
renders as ceil(spp/chunk) chunks whose LCG streams are salted with
i * 0x9E3779B9 (chunk 0 unsalted), which defines the pixels of frames such
as 800x450 at 1000 spp.

Tonemap: average, clamp negatives, firefly clamp 10, pow(c, 1/gamma),
clamp01, u8 with the 255.99 scale, vertical flip (row 0 = top).
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu.config import RenderConfig
from dsrt_tpu_torch.ops import path_kernel
from dsrt_tpu_torch.ops.linalg import f64_op

# primary rays (width * height * spp) per path-kernel launch
FUSED_DISPATCH_RAYS = 256 * 1024 * 1024
SALT_MIX = 0x9E3779B9


def tonemap(accum: torch.Tensor, cfg: RenderConfig, spp: int) -> np.ndarray:
    """(height, width, 3) sums of clamp01(L) over `spp` samples -> u8
    image, row 0 = top."""
    inv_spp = float(np.float32(1.0 / spp))
    inv_gamma = float(np.float32(1.0 / cfg.gamma))
    c = accum * inv_spp
    c = torch.clamp_min(c, 0.0)
    c = torch.clamp_max(c, float(cfg.firefly_clamp))
    c = f64_op(torch.pow, c, inv_gamma)
    c = torch.clamp(c, 0.0, 1.0)
    img = (255.99 * c).to(torch.uint8)
    return torch.flip(img, dims=[0]).cpu().numpy()


def render_frame(scene, cam, cfg: RenderConfig | None = None,
                 with_count: bool = False):
    """The plain renderer, one LCG stream per pixel; (H, W, 3) u8 (and
    the exact ray count with `with_count`)."""
    if cfg is None:
        cfg = RenderConfig(width=cam.width, height=cam.height)
    spp = cfg.resolved_spp()
    accum, nrays = path_kernel.path_render_plain(scene, cam, cfg, spp)
    img = tonemap(accum, cfg, spp)
    return (img, int(nrays)) if with_count else img


def fused_chunk_spp(cfg: RenderConfig,
                    budget: int = FUSED_DISPATCH_RAYS) -> int | None:
    """Samples per launch, or None when the frame fits one launch."""
    spp = cfg.resolved_spp()
    per_spp = cfg.width * cfg.height
    if budget <= 0 or per_spp * spp <= budget:
        return None
    return max(1, budget // per_spp)


def render_accum_fused(scene, cam, cfg: RenderConfig,
                       budget: int = FUSED_DISPATCH_RAYS):
    """Summed accumulators of the chunk schedule and the exact ray count
    (int64 tensor), left on the scene's device."""
    spp = cfg.resolved_spp()
    chunk = fused_chunk_spp(cfg, budget)
    if chunk is None:
        return path_kernel.path_render(scene, cam, cfg, spp, salt=0)
    accum = nrays = None
    done = i = 0
    while done < spp:
        spp_c = min(chunk, spp - done)
        salt = (i * SALT_MIX) & 0xFFFFFFFF
        a, n = path_kernel.path_render(scene, cam, cfg, spp_c, salt=salt)
        accum = a if accum is None else accum + a
        nrays = n if nrays is None else nrays + n
        done += spp_c
        i += 1
    return accum, nrays


def render_frame_fused(scene, cam, cfg: RenderConfig,
                       with_count: bool = False,
                       budget: int = FUSED_DISPATCH_RAYS):
    """One frame through the path kernel; (H, W, 3) u8 (and the exact ray
    count with `with_count`).  Check `path_kernel.fused_supported`
    first: other scenes raise NotImplementedError."""
    accum, nrays = render_accum_fused(scene, cam, cfg, budget)
    img = tonemap(accum, cfg, cfg.resolved_spp())
    return (img, int(nrays)) if with_count else img
