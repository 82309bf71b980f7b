"""Sharded rendering over a rank mesh (port of dsrt_tpu/parallel/render.py).

Every rank builds the scene and the camera itself from the same inputs;
`check_ranks_agree` compares a digest of them across the ranks once a
call, since a rank holding another scene would give a wrong image
silently.  A dp shard is a contiguous block of `render.lane_layout`'s
1024-lane packets: the packet count k is padded up to a multiple of dp
with dead packets, and a rank whose block is all padding joins every
collective and launches nothing.  A rank renders the live pixels of its
block as a pixel list.

- `render_frame_fused_sharded` (JAX :189-242): dp only; each rank runs
  the megakernel that covers the scene once over its pixel list
  (`render.fused_accum`, salt 0, the whole spp: no dispatch budget, as
  JAX's body calls `trace_fused` unchunked).  Pixel streams are
  independent, so the image is the single-process fused frame's while
  the frame fits one launch (`render.FUSED_DISPATCH_RAYS`).
- `render_frame_sharded` (JAX :59-134, :245-284): sp slice i of spp/sp
  samples runs on seed ^ ((i * SP_SEED_MIX) & 0xFFFFFFFF) (slice 0
  unsalted) with global strata i * spp/sp + s and no shutter-time draw,
  as JAX's sharded body (so on a motion-blur scene the image is not
  `render_frame`'s); the walk goes through the traversal kernels.  The
  slices' sums are all-reduced over the sp group in slice order (an
  all-gather, then the sum on the rank's device), so any sp reproduces
  `render_frame_sp_emulated` bit for bit; JAX's psum fixes the order
  only at sp = 2.
- `render_frame_sp_emulated` (JAX :137-186): one process, the same slice
  schedule, the slices' sums added in slice order; the reference of the
  sharded renders.  JAX's raises OverflowError from sp = 3 on
  (`jnp.uint32(i * SP_SEED_MIX)`); here the mix is masked, as in JAX's
  sharded body, where the product wraps.

Each rank tonemaps its rows (`render.tonemap_u8`), and rank 0 gathers
the u8 blocks of the sp = 0 ranks over their dp group and returns the
(H, W, 3) u8 image; the other ranks return None.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from dsrt_tpu_torch.models.scene import FLOAT_META, INT_META, BOOL_META, TABLES
from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops.shade import pixel_grid, stratified_sums
from dsrt_tpu_torch.render import (PACKET, TILE_H, TILE_W, fused_accum,
                                   lanes_to_image, tonemap, tonemap_u8)

SP_SEED_MIX = 0x9E3779B9  # golden-ratio constant for sp-slice decorrelation
# the tables the digest caches once per scene (the sun changes a frame)
_DIGEST_TABLES = tuple(name for name, _ in TABLES if name != "sun_dir")


def packet_shard(width: int, height: int, dp: int, d: int):
    """dp shard d of `render.lane_layout`'s packets, k padded up to a
    multiple of dp with dead packets: its lanes' flat pixel indices
    y * width + x (int64 numpy, (k_pad / dp) * 1024 lanes; meaningful
    where live), its live lanes (bool), and (ty, tx, k) of the whole
    layout.  Computed for the shard's packets alone: lane l of packet p
    is pixel (p % tx * 32 + l % 32, p // tx * 32 + l // 32)."""
    tx, ty = -(-width // TILE_W), -(-height // TILE_H)
    k = tx * ty
    k_loc = -(-k // dp)
    p = np.arange(d * k_loc, (d + 1) * k_loc, dtype=np.int64)[:, None]
    lane = np.arange(PACKET, dtype=np.int64)[None, :]
    y = p // tx * TILE_H + lane // TILE_W
    x = p % tx * TILE_W + lane % TILE_W
    live = (p < k) & (x < width) & (y < height)
    return (y * width + x).reshape(-1), live.reshape(-1), (ty, tx, k)


def rank_shard(cfg, mesh):
    """packet_shard of this rank's dp shard."""
    return packet_shard(cfg.width, cfg.height, mesh.dp, mesh.dp_index)


def shard_pixels(shard, device) -> torch.Tensor:
    """The live pixels of a packet_shard, in lane order, as a 1-D int64
    tensor on `device` (empty on an all-padding shard)."""
    pix, live, _ = shard
    return torch.as_tensor(pix[live], device=device)


def _tables_digest(scene) -> bytes:
    def make():
        h = hashlib.sha256()
        for name in _DIGEST_TABLES:
            a = getattr(scene, name).detach().cpu().contiguous().numpy()
            h.update(f"{name} {a.dtype} {a.shape}".encode())
            h.update(a.tobytes())
        h.update(repr([getattr(scene, m)
                       for m in INT_META + BOOL_META + FLOAT_META]).encode())
        return h.digest()
    return scene.cached("rank digest",
                        tuple(getattr(scene, n) for n in _DIGEST_TABLES), make)


def check_ranks_agree(scene, cam, cfg, mesh) -> None:
    """Raise on every rank when some rank's scene (tables and sun),
    camera or config differs from rank 0's; the tables' digest is kept
    once per scene."""
    h = hashlib.sha256(_tables_digest(scene))
    h.update(scene.sun_dir.detach().cpu().numpy().tobytes())
    h.update(cam.vector().detach().cpu().numpy().tobytes())
    h.update(repr(cfg).encode())
    mine = torch.as_tensor(np.frombuffer(h.digest(), np.int64).copy(),
                           device=mesh.comm_device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    bad = [r for r, d in enumerate(every) if not torch.equal(d, every[0])]
    if bad:
        raise RuntimeError(f"ranks {bad} hold another scene, camera or "
                           "config than rank 0")


def gather_frame(mesh, cfg, shard, rows_u8: torch.Tensor):
    """Rank 0: the (H, W, 3) u8 image (numpy, row 0 = top) from every dp
    shard's tonemapped rows (this rank's `rows_u8`, (n, 3) in the order of
    shard_pixels of its `shard`); the other ranks: None."""
    pix, live, (ty, tx, k) = shard
    if mesh.sp_index != 0:
        return None
    dev = mesh.comm_device
    lanes = torch.zeros((pix.size, 3), dtype=torch.uint8, device=dev)
    lanes[torch.as_tensor(live, device=dev)] = rows_u8.to(dev)
    bufs = ([torch.empty_like(lanes) for _ in range(mesh.dp)]
            if mesh.rank == 0 else None)
    dist.gather(lanes, bufs, dst=0, group=mesh.group("dp"))
    if mesh.rank != 0:
        return None
    full = torch.cat(bufs).reshape(-1, PACKET, 3)[:k]
    img = lanes_to_image(full, ty, tx)[:cfg.height, :cfg.width]
    return torch.flip(img, dims=[0]).cpu().numpy()


def slice_sums(scene, cam, cfg, pix: torch.Tensor, i: int, spp_local: int,
               walk: str = "kernel"):
    """The (n, 3) sums and exact ray count of sp slice i (spp_local
    samples) over the flat pixels `pix`; `walk` "kernel" goes through the
    traversal kernels, "plain" through the plain walk (the reference)."""
    px, py = pix % cfg.width, pix // cfg.width
    mix = (i * SP_SEED_MIX) & rngmod.MASK32   # 0 for slice 0
    state = rngmod.seed_pixels(px, py, cam.width, scene.seed, mix)
    strata = range(i * spp_local, (i + 1) * spp_local)
    return stratified_sums(scene, cam, cfg, px, py, state, strata, walk)


def _sum_in_slice_order(mesh, sums: torch.Tensor) -> torch.Tensor:
    """Every sp slice's sums added in slice order, on every rank of the
    sp group."""
    if mesh.sp == 1:
        return sums
    mine = sums.to(mesh.comm_device)
    parts = [torch.empty_like(mine) for _ in range(mesh.sp)]
    dist.all_gather(parts, mine, group=mesh.group("sp"))
    total = parts[0].to(sums.device)
    for p in parts[1:]:
        total = total + p.to(sums.device)
    return total


def render_frame_sharded(scene, cam, cfg, mesh):
    """Render one frame across the mesh through the traversal kernels;
    (H, W, 3) u8 on rank 0, None elsewhere.  spp must be divisible by sp
    (ValueError)."""
    spp = cfg.resolved_spp()
    if spp % mesh.sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sp={mesh.sp}")
    check_ranks_agree(scene, cam, cfg, mesh)
    shard = rank_shard(cfg, mesh)
    sums, _ = slice_sums(scene, cam, cfg, shard_pixels(shard, scene.device),
                         mesh.sp_index, spp // mesh.sp)
    return gather_frame(mesh, cfg, shard,
                        tonemap_u8(_sum_in_slice_order(mesh, sums), cfg, spp))


def render_frame_fused_sharded(scene, cam, cfg, mesh, with_count=False):
    """dp-sharded megakernel frame: each rank's shard as one pixel-list
    launch of the kernel that covers the scene (callers gate on
    `render.fused_kind`).  (H, W, 3) u8 on rank 0, None elsewhere; with
    `with_count`, (image, exact ray count summed in int64 over ranks) on
    every rank.  The mesh must be dp only (ValueError)."""
    if mesh.sp != 1:
        raise ValueError("fused sharding is dp-only; build the mesh with "
                         f"sp=1 (got sp={mesh.sp})")
    check_ranks_agree(scene, cam, cfg, mesh)
    spp = cfg.resolved_spp()
    shard = rank_shard(cfg, mesh)
    accum, nrays = fused_accum(scene, cam, cfg, spp, 0,
                               shard_pixels(shard, scene.device))
    img = gather_frame(mesh, cfg, shard, tonemap_u8(accum, cfg, spp))
    if not with_count:
        return img
    total = nrays.reshape(1).to(torch.int64).to(mesh.comm_device)
    dist.all_reduce(total)
    return img, int(total)


def render_frame_sp_emulated(scene, cam, cfg, sp: int,
                             walk: str = "kernel") -> np.ndarray:
    """One process, the exact slice schedule of render_frame_sharded (seed
    ^ i * SP_SEED_MIX masked, spp/sp strata a slice, the sums added in
    slice order); (H, W, 3) u8, the reference of the sharded renders.
    `walk` as in slice_sums: "plain" keeps the traversal kernels out of
    the reference on a CUDA scene.  sp must divide spp (ValueError)."""
    spp = cfg.resolved_spp()
    if spp % sp != 0:
        raise ValueError(f"sp={sp} must divide spp={spp}")
    px, py = pixel_grid(cfg.width, cfg.height, scene.device)
    pix = py * cfg.width + px
    total = None
    for i in range(sp):
        sums, _ = slice_sums(scene, cam, cfg, pix, i, spp // sp, walk)
        total = sums if total is None else total + sums
    return tonemap(total.reshape(cfg.height, cfg.width, 3), cfg, spp)
