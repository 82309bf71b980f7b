"""Frame rendering: the sample loop, the salted-chunk schedule, the split
pipeline's entry points, adaptive sampling, the debug and radiance
renders, the asynchronous frame, tonemap.

Port of dsrt_tpu/render.py:51-78 (`lane_layout`, `lanes_to_image`),
:82-153 (`render_frame`, the parity renderer), :159-182
(`render_frame_wavefront`), :185-247 (`render_frame_fused`, `fused_kind`),
:274-338 (the per-dispatch ray budget, `fused_accum`), :341-432
(`render_frame_adaptive`), :435-483 (`render_frame_queue`), :570-689
(`render_radiance`, `render_frame_debug`) and :692-721
(`render_frame_async`).

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

`render_frame_async` issues a fused or wavefront frame as the
`PendingFrame` the driver's loop takes from every renderer; `finish`
brings it to the host, and `render_frame_fused` and
`render_frame_wavefront` are `finish` of it.

`render_frame_adaptive` renders split-buffer rounds over a shrinking
set of active pixels through the megakernels' pixel-list launch
(`fused_accum`); its sums, convergence test and tonemap run in float64
numpy on the host in JAX's order of operations.

Tonemap (`tonemap_u8`): average, clamp negatives, firefly clamp 10,
pow(c, 1/gamma), clamp01, u8 with the 255.99 scale; then the vertical
flip (row 0 = top).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.materials import DIFFUSE_LIGHT
from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops import textures as texmod
from dsrt_tpu_torch.ops.camera import camera_rays
from dsrt_tpu_torch.ops.linalg import (V3, clamp01, const, f64_op, normalize,
                                       where as vwhere)
from dsrt_tpu_torch.ops.shade import pixel_grid, render_samples
from dsrt_tpu_torch.ops.trace import scene_hit_flat
from dsrt_tpu_torch.ops.wavefront import trace_accumulate, trace_queue
from dsrt_tpu_torch.utils.debug import check_accumulator

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


def tonemap_u8(accum: torch.Tensor, cfg: RenderConfig,
               spp: int) -> torch.Tensor:
    """(..., 3) sums of clamp01(L) over `spp` samples -> u8 tensor of the
    same shape on the sums' device, unflipped.  Inside
    utils.debug.debug_nans a non-finite sum raises FloatingPointError."""
    check_accumulator(accum)
    inv_spp = float(np.float32(1.0 / spp))
    inv_gamma = float(np.float32(1.0 / cfg.gamma))
    c = accum * inv_spp
    c = torch.clamp_min(c, 0.0)
    c = torch.clamp_max(c, float(cfg.firefly_clamp))
    c = f64_op(torch.pow, c, inv_gamma)
    c = torch.clamp(c, 0.0, 1.0)
    return (255.99 * c).to(torch.uint8)


def tonemap_device(accum: torch.Tensor, cfg: RenderConfig,
                   spp: int) -> torch.Tensor:
    """(height, width, 3) sums of clamp01(L) over `spp` samples -> u8
    image tensor on the sums' device, row 0 = top (tonemap_u8, then the
    vertical flip)."""
    return torch.flip(tonemap_u8(accum, cfg, spp), dims=[0])


def tonemap(accum: torch.Tensor, cfg: RenderConfig, spp: int) -> np.ndarray:
    """tonemap_device, brought to the host as a numpy u8 image."""
    return tonemap_device(accum, cfg, spp).cpu().numpy()


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
    img, nrays = finish(render_frame_async(scene, cam, cfg, "fused",
                                           budget=budget))
    return (img, nrays) if with_count else img


def fused_accum(scene, cam, cfg: RenderConfig, spp: int, salt: int,
                pixels: torch.Tensor):
    """The sums of `spp` samples with stream salt `salt` over a pixel set
    (flat indices y * width + x on the scene's device), (n, 3), and the
    exact ray count, through the megakernel that covers the scene (its
    pixel-list launch; the plain version on a CPU scene).  Other scenes
    raise NotImplementedError."""
    _, launch, why = _kernel_of(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    return launch(scene, cam, cfg, spp, salt=salt, pixels=pixels)


def render_frame_adaptive(scene, cam, cfg: RenderConfig, tol: float = 0.02,
                          chunk_spp: int | None = None,
                          with_count: bool = False):
    """Variance-guided adaptive sampling over the megakernels.

    Rounds of `chunk_spp` samples (default max(4, cap // 8), cfg.spp the
    per-pixel cap) alternate between buckets A and B, round r salted
    r * 0x9E3779B9; from round 2 on a pixel whose two bucket means agree,
    |mean_A - mean_B|max <= tol * (luminance + 0.02), drops out, and each
    round launches only the active pixels.  Returns (H, W, 3) u8 (and
    with `with_count` the stats dict: exact `rays`, `samples`,
    `mean_spp`, `rounds`).  A scene neither megakernel covers raises
    ValueError."""
    if fused_kind(scene, cfg) is None:
        raise ValueError("adaptive sampling needs a scene one of the "
                         "megakernels covers (render_frame_wavefront "
                         "covers the rest)")
    max_spp = cfg.resolved_spp()
    if chunk_spp is None:
        chunk_spp = max(4, max_spp // 8)
    h, w = cfg.height, cfg.width
    npix = h * w
    sums = np.zeros((2, npix, 3), np.float64)   # bucket A/B sums
    ns = np.zeros((2, npix), np.int64)
    active = np.ones(npix, bool)
    total_rays = 0
    rounds = 0
    spp_done = 0    # every active pixel carries the same total
    while active.any() and spp_done < max_spp:
        idx = np.nonzero(active)[0]
        bucket = rounds % 2
        spp_c = min(chunk_spp, max_spp - spp_done)
        salt = (rounds * SALT_MIX) & 0xFFFFFFFF
        accum, nr = fused_accum(scene, cam, cfg, spp_c, salt,
                                torch.as_tensor(idx, device=scene.device))
        total_rays += int(nr)
        sums[bucket, idx] += accum.cpu().numpy()
        ns[bucket, idx] += spp_c
        spp_done += spp_c
        rounds += 1
        if rounds < 2:
            continue                     # both buckets needed to compare
        a, b = sums[0, idx], sums[1, idx]
        na = np.maximum(ns[0, idx], 1)[:, None]
        nb = np.maximum(ns[1, idx], 1)[:, None]
        ma, mb = a / na, b / nb
        err = np.abs(ma - mb).max(axis=-1)
        lum = 0.5 * (ma + mb) @ np.array([0.2126, 0.7152, 0.0722])
        done = err <= tol * (lum + 0.02)
        active[idx[done]] = False

    check_accumulator(sums)
    n_tot = np.maximum(ns.sum(0), 1)[:, None]
    c = sums.sum(0) / n_tot
    c = np.maximum(c, 0.0)
    c = np.minimum(c, cfg.firefly_clamp)
    c = np.power(c, 1.0 / cfg.gamma)
    c = np.clip(c, 0.0, 1.0)
    img = (255.99 * c).astype(np.uint8).reshape(h, w, 3)[::-1]
    if with_count:
        return img, dict(rays=total_rays, samples=int(ns.sum()),
                         mean_spp=float(ns.sum() / npix), rounds=rounds)
    return img


def render_radiance(scene, cam, cfg: RenderConfig) -> np.ndarray:
    """The parity renderer's mean of clamped samples before the tonemap,
    (H, W, 3) float32, row 0 = top; its walk goes through the traversal
    kernels on a CUDA scene."""
    spp = cfg.resolved_spp()
    accum, _ = render_samples(scene, cam, cfg, spp, walk="kernel")
    rad = accum * float(np.float32(1.0 / spp))
    return torch.flip(rad, dims=[0]).cpu().numpy()


def render_frame_debug(scene, cam, cfg: RenderConfig) -> np.ndarray:
    """Flat-shade debug render (the reference's ray_color_debug): one
    scene intersection a sample, jittered as the path tracer is; lights
    render white, surfaces clamp01(albedo x image texture), misses the
    sky (cfg.sky_type "solid": cfg.sky_solid; "gradient": the lerp of
    cfg.sky_bottom to cfg.sky_top by 0.5 (y + 1) of the unit direction).
    Same tonemap; (H, W, 3) u8.  The walk goes through the traversal
    kernel on a CUDA scene."""
    dev = scene.device
    cam = cam.to(dev)
    spp = cfg.resolved_spp()
    px, py = pixel_grid(cfg.width, cfg.height, dev)
    state = rngmod.seed_pixels(px, py, cam.width, scene.seed)
    valid = torch.ones(px.shape, dtype=torch.bool, device=dev)
    zero = torch.zeros(px.shape, dtype=torch.float32, device=dev)
    one = torch.ones_like(zero)
    acc = V3(zero, zero, zero)
    spp_t = const(spp, dev)
    for s in range(spp):
        jxu, state = rngmod.draw(state, valid)
        jyu, state = rngmod.draw(state, valid)
        sf = const(s, dev)
        jx = (sf + jxu) / spp_t
        jy = (sf + jyu) / spp_t
        ro, rd, state = camera_rays(cam, px, py, jx, jy, state, valid,
                                    cfg.aperture > 0)
        hit, state = scene_hit_flat(scene, ro, rd, float(cfg.hit_eps), 1e30,
                                    valid, state)
        if cfg.sky_type == "gradient":
            t = 0.5 * (normalize(rd).y + 1.0)
            sky = V3(*(cfg.sky_bottom[k] * (1.0 - t) + cfg.sky_top[k] * t
                       for k in range(3)))
        else:
            sky = V3(*(torch.full_like(zero, cfg.sky_solid[k])
                       for k in range(3)))
        mp = scene.mat_pack[hit.mat]
        base = V3(mp[..., 1], mp[..., 2], mp[..., 3])
        if scene.has_image_tex:
            tex_rgb = texmod.sample_image(scene, hit.tex, hit.tu, hit.tv)
            base = vwhere(hit.tex >= 0, base * tex_rgb, base)
        is_light = mp[..., 0].to(torch.int64) == DIFFUSE_LIGHT
        base = vwhere(is_light, V3(one, one, one), base)
        acc = acc + vwhere(hit.hit, clamp01(base), sky)
    sums = torch.stack(list(acc), dim=-1).reshape(cfg.height, cfg.width, 3)
    return tonemap(sums, cfg, spp)


def _wavefront_accum(scene, cam, cfg: RenderConfig, spp_batch: int):
    """(height, width, 3) sums and the exact ray count of the split
    pipeline with `spp_batch` sample slots per pixel (dividing spp)."""
    spp = cfg.resolved_spp()
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
    return lanes_to_image(folded, ty, tx)[:cfg.height, :cfg.width], nrays


def render_frame_wavefront(scene, cam, cfg: RenderConfig, spp_batch: int = 8,
                           with_count: bool = False):
    """The split pipeline with per-lane regeneration: `spp_batch` sample
    slots per pixel (must divide spp), decorrelated streams; (H, W, 3) u8
    (and the exact ray count with `with_count`)."""
    spp = cfg.resolved_spp()
    if spp % spp_batch != 0:
        raise ValueError(f"spp_batch={spp_batch} must divide spp={spp}")
    img, nrays = finish(render_frame_async(scene, cam, cfg, "wavefront",
                                           spp_batch))
    return (img, nrays) if with_count else img


def fit_spp_batch(spp: int, spp_batch: int) -> int:
    """`spp_batch` halved until it divides `spp` (at least 1)."""
    while spp_batch > 1 and spp % spp_batch != 0:
        spp_batch //= 2
    return max(spp_batch, 1)


@dataclasses.dataclass
class PendingFrame:
    """A frame handed to the frame loop: its u8 image, row 0 = top, and
    its exact ray count, None where the renderer counts none.  From
    render_frame_async on the card both are in pinned host memory,
    copied when `done` fires; `done` is None when the frame is complete
    (a CPU frame, or an image already on the host)."""
    img: "torch.Tensor | np.ndarray"
    nrays: "torch.Tensor | int | None" = None
    done: "torch.cuda.Event | None" = None


def render_frame_async(scene, cam, cfg: RenderConfig, mode: str = "fused",
                       spp_batch: int = 8,
                       budget: int = FUSED_DISPATCH_RAYS) -> PendingFrame:
    """Issue one frame and return without waiting for it: `mode` "fused"
    (render_accum_fused with `budget`) or "wavefront" (`spp_batch` slots,
    halved until they divide spp).  On the card the frame's work, the
    tonemap, the copies of the image and the ray count into pinned host
    memory and an event all go on the current stream, so `finish` waits
    for this frame alone, and a frame issued after it can run while the
    caller encodes this one.  On the CPU it runs to the end."""
    spp = cfg.resolved_spp()
    if mode == "fused":
        accum, nrays = render_accum_fused(scene, cam, cfg, budget)
    elif mode == "wavefront":
        accum, nrays = _wavefront_accum(scene, cam, cfg,
                                        fit_spp_batch(spp, spp_batch))
    else:
        raise ValueError(f"mode must be 'fused' or 'wavefront', got {mode!r}")
    img = tonemap_device(accum, cfg, spp)
    nrays = nrays.reshape(())
    if img.device.type != "cuda":
        return PendingFrame(img, nrays, None)
    host_img = torch.empty(img.shape, dtype=torch.uint8, pin_memory=True)
    host_img.copy_(img, non_blocking=True)
    host_n = torch.empty((), dtype=torch.int64, pin_memory=True)
    host_n.copy_(nrays, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return PendingFrame(host_img, host_n, done)


def finish(frame: PendingFrame):
    """(numpy u8 image, exact ray count or None) of a frame, after
    waiting for that frame's event only."""
    if frame.done is not None:
        frame.done.synchronize()
    return (np.asarray(frame.img),
            None if frame.nrays is None else int(frame.nrays))


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
