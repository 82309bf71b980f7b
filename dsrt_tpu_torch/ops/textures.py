"""Image-texture lookup (port of dsrt_tpu/ops/textures.py:23-42).

Nearest-neighbour fetch from the flat RGB pool: wrap u, v to [0, 1) by
floor-frac, V-flip j = (1 - v)(h - 1), truncating float->int texel
index, white on an invalid id or an out-of-range index (idx + 2 must be
below the pool length).
"""

from __future__ import annotations

import torch

from dsrt_tpu_torch.ops.linalg import V3


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
