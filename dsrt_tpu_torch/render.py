"""Frame rendering: the sample loop, the salted-chunk schedule, the split
pipeline's entry points, tonemap.

Port of dsrt_tpu/render.py:51-78 (`lane_layout`, `lanes_to_image`),
:82-153 (`render_frame`, the parity renderer), :159-182
(`render_frame_wavefront`), :185-247 (`render_frame_fused`, `fused_kind`),
:274-338 (the per-dispatch ray budget) and :435-483 (`render_frame_queue`).

`render_frame` runs the PyTorch path tracer on the scene's device, its
walk through the traversal kernels on CUDA (ops/traverse.py).
`render_frame_wavefront` and `render_frame_queue` are the split pipeline
(ops/wavefront.py): eager shading waves over lane pools laid out as JAX
lays them out, 1024-lane packets of 32x32-pixel tiles, so pool sizes,
drain caps and compaction match JAX lane for lane.
`render_frame_fused` runs one of the two megakernels on a CUDA scene (and
its plain version on a CPU scene): scenes with triangles or quads go to
the path kernel (ops/path_kernel.py: with up to 12 spheres, 24 quads, 8
area lights and 4 media, smooth or flat, any sky, texture, lens and
shutter), sphere-only scenes to the sphere kernel (ops/sphere_kernel.py);
a scene that neither covers raises.  A frame
above FUSED_DISPATCH_RAYS primary rays renders as ceil(spp/chunk) chunks
whose LCG streams are salted with i * 0x9E3779B9 (chunk 0 unsalted),
which defines the pixels of frames such as 800x450 at 1000 spp.

Tonemap: average, clamp negatives, firefly clamp 10, pow(c, 1/gamma),
clamp01, u8 with the 255.99 scale, vertical flip (row 0 = top).
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
from dsrt_tpu_torch.ops.linalg import f64_op
from dsrt_tpu_torch.ops.shade import render_samples
from dsrt_tpu_torch.ops.wavefront import trace_accumulate, trace_queue

# primary rays (width * height * spp) per kernel launch
FUSED_DISPATCH_RAYS = 256 * 1024 * 1024
SALT_MIX = 0x9E3779B9
# a lane packet is a TILE_H x TILE_W pixel tile (JAX exec_opts.layout)
TILE_H = 32
TILE_W = 32
PACKET = TILE_H * TILE_W
# a queue band's (pixel, sample) ids plus its pool stay below this
QUEUE_ID_LIMIT = 2 ** 31 - 1


def lane_layout(width: int, height: int):
    """Pixel-to-lane mapping: (K, 1024) int64 numpy arrays px, py and the
    bool `valid`, each packet a 32x32 pixel tile; and (ty, tx), the tile
    grid."""
    tx = -(-width // TILE_W)
    ty = -(-height // TILE_H)
    ys, xs = np.mgrid[0:ty * TILE_H, 0:tx * TILE_W]

    def to_lanes(a):
        return (a.reshape(ty, TILE_H, tx, TILE_W).transpose(0, 2, 1, 3)
                .reshape(ty * tx, PACKET))

    px, py = to_lanes(xs).astype(np.int64), to_lanes(ys).astype(np.int64)
    return px, py, (px < width) & (py < height), (ty, tx)


def lanes_to_image(vals: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """(K, 1024, ...) lane tensor -> (Hp, Wp, ...) padded image (the
    inverse of lane_layout)."""
    rest = tuple(vals.shape[2:])
    return (vals.reshape((ty, tx, TILE_H, TILE_W) + rest)
            .transpose(1, 2).reshape((ty * TILE_H, tx * TILE_W) + rest))


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
    """The parity renderer, one LCG stream per pixel; (H, W, 3) u8 (and
    the exact ray count with `with_count`).  Its walk goes through the
    traversal kernels on a CUDA scene (their plain versions on a CPU
    scene)."""
    if cfg is None:
        cfg = RenderConfig(width=cam.width, height=cam.height)
    spp = cfg.resolved_spp()
    accum, nrays = render_samples(scene, cam, cfg, spp, walk="kernel")
    img = tonemap(accum, cfg, spp)
    return (img, int(nrays)) if with_count else img


def _kernel_of(scene, cfg):
    """(kind, wrapper, why not covered) of the megakernel for this scene:
    'tri' for scenes with triangles or quads, else 'sphere'."""
    if scene.n_tris > 0 or scene.n_quads > 0:
        return ("tri", path_kernel.path_render,
                path_kernel.scope_error(scene, cfg))
    return ("sphere", sphere_kernel.sphere_render,
            sphere_kernel.scope_error(scene, cfg))


def fused_kind(scene, cfg) -> str | None:
    """Which megakernel covers this scene: 'tri' (the path kernel),
    'sphere' (the sphere kernel), or None."""
    kind, _, why = _kernel_of(scene, cfg)
    return kind if why is None else None


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
    _, launch, why = _kernel_of(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    spp = cfg.resolved_spp()
    chunk = fused_chunk_spp(cfg, budget)
    if chunk is None:
        return launch(scene, cam, cfg, spp, salt=0)
    accum = nrays = None
    done = i = 0
    while done < spp:
        spp_c = min(chunk, spp - done)
        salt = (i * SALT_MIX) & 0xFFFFFFFF
        a, n = launch(scene, cam, cfg, spp_c, salt=salt)
        accum = a if accum is None else accum + a
        nrays = n if nrays is None else nrays + n
        done += spp_c
        i += 1
    return accum, nrays


def render_frame_fused(scene, cam, cfg: RenderConfig,
                       with_count: bool = False,
                       budget: int = FUSED_DISPATCH_RAYS):
    """One frame through the megakernel that covers the scene; (H, W, 3)
    u8 (and the exact ray count with `with_count`).  Check `fused_kind`
    first: other scenes raise NotImplementedError."""
    accum, nrays = render_accum_fused(scene, cam, cfg, budget)
    img = tonemap(accum, cfg, cfg.resolved_spp())
    return (img, int(nrays)) if with_count else img


def render_frame_wavefront(scene, cam, cfg: RenderConfig, spp_batch: int = 8,
                           with_count: bool = False):
    """The split pipeline with per-lane regeneration: `spp_batch` sample
    slots per pixel (must divide spp), decorrelated streams; (H, W, 3) u8
    (and the exact ray count with `with_count`)."""
    spp = cfg.resolved_spp()
    if spp % spp_batch != 0:
        raise ValueError(f"spp_batch={spp_batch} must divide spp={spp}")
    dev = scene.device
    px, py, valid, (ty, tx) = lane_layout(cfg.width, cfg.height)
    k = px.shape[0]

    def tiled(a):
        return torch.as_tensor(np.tile(a, (spp_batch, 1)), device=dev)

    slot = torch.as_tensor(np.repeat(np.arange(spp_batch), k)[:, None]
                           .repeat(PACKET, axis=1), device=dev)
    accum, nrays = trace_accumulate(scene, cfg, cam, tiled(px), tiled(py),
                                    tiled(valid), slot, spp // spp_batch)
    folded = torch.stack([c.reshape(spp_batch, k, PACKET).sum(dim=0)
                          for c in accum], dim=-1)
    img = tonemap(lanes_to_image(folded, ty, tx)[:cfg.height, :cfg.width],
                  cfg, spp)
    return (img, int(nrays)) if with_count else img


def render_frame_queue(scene, cam, cfg: RenderConfig, pool_packets: int = 0):
    """The split pipeline as one global work queue over every (pixel,
    sample) unit; `pool_packets` = lanes in flight / 1024 (0: one
    frame's packets).  Frames whose unit ids would overflow int32 render
    in horizontal bands through the same queue, each with its own id
    space (seeds use frame coordinates, so the image is the same)."""
    px, _, _, _ = lane_layout(cfg.width, cfg.height)
    k = pool_packets or px.shape[0]
    spp = cfg.resolved_spp()
    band_h = cfg.height
    while cfg.width * band_h * spp + k * PACKET >= QUEUE_ID_LIMIT:
        band_h = (band_h + 1) // 2
    bands = []
    y0 = 0
    while y0 < cfg.height:
        bh = min(band_h, cfg.height - y0)
        accum, _ = trace_queue(scene, cfg, cam, cfg.width, bh, (k, PACKET),
                               y0=y0)
        bands.append(tonemap(accum.reshape(bh, cfg.width, 3), cfg, spp))
        y0 += bh
    # each band is flipped (row 0 = its top): the frame's top band is last
    return np.concatenate(bands[::-1], axis=0)
