"""Wrapper of the CUDA kernel in csrc/path_kernel.cu, its plain PyTorch
version, its launch counter, and the pixel-list launch the sphere
kernel's wrapper shares.

Port of dsrt_tpu/ops/pallas_path.py over its whole scope
(`fused_supported`, :101-133, as `scope_error`, with the limits of
:464-468) and the frame entry `trace_fused` (:3684-3938).  The wrapper
packs the scene's sphere, quad, light and medium records once per scene
(`pack_params`, kept by `Scene.cached`, which the per-frame copies that
`Scene.with_sun` make share) and the sun vector once per sun direction;
each launch then passes the camera vector, the runtime feature flags and
the kernel instance the scene needs (`instance_of`).  The kernel walks
the scene's 8-ary table `wide_pack` (csrc/wide_walk.cuh) with a stack of
WIDE_STACK entries a thread, as deep as the TPU kernel's; a tree whose
worst stack height `Scene.wide_stack` is deeper is refused.  A launch
renders the whole frame or, as the TPU kernel's lane set does, a list of
pixels (`pixels`, flat indices y * width + x): the wrapper checks the
list, orders it by 8x4 tile (`tile_order`) and puts the rows back in the
caller's order (`list_launch`, which the sphere kernel's wrapper shares).
The wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
LAUNCHES counts kernel launches, so a caller can show a run went through
the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.device import to_device
from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.build import (WIDE_STACK, check_tables, i32, ptr,
                                      require_cuda)
from dsrt_tpu_torch.ops.shade import (check_scope, render_samples,
                                      sun_ldir_host)
from dsrt_tpu_torch.utils import timing

LAUNCHES = {"dsrt_path_render": 0}
# scene limits of the kernel (csrc/path_kernel.cuh `Params`)
MAX_SPH = 12
MAX_QUADS = 24
MAX_LIGHTS = 8
MAX_MED = 4
# a warp's pixel tile (csrc/path_kernel.cuh TILE_W, TILE_H)
TILE_W, TILE_H = 8, 4
# floats of the packed records: spheres (8 each), quads (18), lights (2),
# media (15)
PARAM_LEN = 8 * MAX_SPH + 18 * MAX_QUADS + 2 * MAX_LIGHTS + 15 * MAX_MED
# template bits of the kernel instance and runtime bits of its flags
K_PRIMS, K_MEDIA, K_LIGHTS, K_EXTRA = 1, 2, 4, 8
N_INSTANCES = 16
(SUN_ON, TEXTURED, ENV, PTEX, SMOOTH, APERTURE, SHUTTER,
 MOVING) = (1, 2, 4, 8, 16, 32, 64, 128)
EXTRA_FLAGS = ENV | PTEX | SMOOTH | APERTURE | SHUTTER | MOVING


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scope_error(scene, cfg) -> str | None:
    """Why the path kernel does not cover this scene and config, or None.
    It covers scenes with triangles or quads, with up to 12 spheres, 24
    quads, 8 area lights and 4 constant media, any camera and shutter."""
    try:
        check_scope(scene, cfg)
    except NotImplementedError as e:
        return str(e)
    if scene.n_tris == 0 and scene.n_quads == 0:
        return "the path kernel needs triangles or quads"
    if (scene.n_spheres > MAX_SPH or scene.n_quads > MAX_QUADS
            or scene.n_lights > MAX_LIGHTS or scene.n_media > MAX_MED):
        return (f"the path kernel takes at most {MAX_SPH} spheres, "
                f"{MAX_QUADS} quads, {MAX_LIGHTS} lights and {MAX_MED} media "
                f"(scene: {scene.n_spheres}, {scene.n_quads}, "
                f"{scene.n_lights}, {scene.n_media})")
    return None


def flags_of(scene, cfg) -> int:
    """The kernel's runtime feature flags for this scene and config."""
    flags = ((SUN_ON if scene.sun_enabled else 0)
             | (TEXTURED if scene.has_image_tex else 0)
             | (ENV if scene.env_tex >= 0 else 0)
             | (PTEX if scene.has_ptex else 0)
             | (SMOOTH if scene.has_smooth else 0)
             | (APERTURE if cfg.aperture > 0 else 0))
    if cfg.time1 > cfg.time0:
        # the shutter draw happens with the shutter open, moving spheres
        # or not; the centre lerp only with moving spheres
        flags |= SHUTTER | (MOVING if scene.has_moving else 0)
    return flags


def instance_of(scene, cfg) -> int:
    """The kernel instance (template bits) this scene and config launch:
    0 is the flagship's triangle-only path."""
    return ((K_PRIMS if scene.n_spheres or scene.n_quads else 0)
            | (K_MEDIA if scene.n_media else 0)
            | (K_LIGHTS if scene.n_lights else 0)
            | (K_EXTRA if flags_of(scene, cfg) & EXTRA_FLAGS else 0))


def _param_sources(scene) -> tuple:
    return (scene.sph_center, scene.sph_center2, scene.sph_radius,
            scene.sph_mat, scene.quad_q, scene.quad_u, scene.quad_v,
            scene.quad_n, scene.quad_w, scene.quad_d, scene.quad_area,
            scene.quad_mat, scene.light_idx, scene.light_kind,
            scene.med_kind, scene.med_center, scene.med_radius,
            scene.med_min, scene.med_max, scene.med_neg_inv_density,
            scene.med_albedo)


def _pack_params(scene) -> torch.Tensor:
    def host(t):
        return t.detach().cpu().numpy()

    ns, nq, nl, nm = (scene.n_spheres, scene.n_quads, scene.n_lights,
                      scene.n_media)
    sph = np.zeros((MAX_SPH, 8), np.float32)
    quad = np.zeros((MAX_QUADS, 18), np.float32)
    lit = np.zeros((MAX_LIGHTS, 2), np.float32)
    med = np.zeros((MAX_MED, 15), np.float32)
    if ns:
        sph[:ns, 0:3] = host(scene.sph_center)[:ns]
        sph[:ns, 3] = host(scene.sph_radius)[:ns]
        sph[:ns, 4] = host(scene.sph_mat)[:ns]
        sph[:ns, 5:8] = host(scene.sph_center2)[:ns]
    if nq:
        for col, name in ((0, "quad_q"), (3, "quad_u"), (6, "quad_v"),
                          (9, "quad_n"), (12, "quad_w")):
            quad[:nq, col:col + 3] = host(getattr(scene, name))[:nq]
        quad[:nq, 15] = host(scene.quad_d)[:nq]
        quad[:nq, 16] = host(scene.quad_mat)[:nq]
        quad[:nq, 17] = host(scene.quad_area)[:nq]
    if nl:
        lit[:nl, 0] = host(scene.light_kind)[:nl]
        lit[:nl, 1] = host(scene.light_idx)[:nl]
    if nm:
        med[:nm, 0] = host(scene.med_kind)[:nm]
        med[:nm, 1:4] = host(scene.med_center)[:nm]
        med[:nm, 4] = host(scene.med_radius)[:nm]
        med[:nm, 5:8] = host(scene.med_min)[:nm]
        med[:nm, 8:11] = host(scene.med_max)[:nm]
        med[:nm, 11] = host(scene.med_neg_inv_density)[:nm]
        med[:nm, 12:15] = host(scene.med_albedo)[:nm]
    flat = np.concatenate([sph.ravel(), quad.ravel(), lit.ravel(),
                           med.ravel()])
    return torch.as_tensor(flat, device=scene.device)


def pack_params(scene) -> torch.Tensor:
    """The kernel's primitive records, f32[PARAM_LEN] on the scene's
    device: per sphere c0, radius, material, c2; per quad q, u, v, n, w,
    d, material, area; per light its kind (0 sphere, 1 quad) and row; per
    medium kind, centre, radius, box min and max, -1/density, albedo.
    Packed once per scene."""
    return scene.cached("path_params", _param_sources(scene),
                        lambda: _pack_params(scene))


def sun_vector(scene, shadow_bias: float) -> torch.Tensor:
    """Ldir (normalised on the host as the plain version does), the sun
    radiance and the shadow bias, f32[7] on the scene's device; made once
    per sun direction from the scene's host copies of its sun, with no
    read from the device, in one copy (`to_device`)."""
    def make():
        return to_device(np.array(
            [float(c) for c in sun_ldir_host(scene)]
            + scene.sun_radiance_host.tolist() + [float(shadow_bias)],
            np.float32), scene.device)
    return scene.cached(f"sun {float(shadow_bias)!r}",
                        (scene.sun_dir, scene.sun_radiance), make)


def _wide_tables(scene):
    """(wide_pack, tri_pack) pointers after the checks the kernel needs."""
    if scene.wide_stack > WIDE_STACK:
        raise ValueError(
            f"the scene's BVH needs a walk stack of {scene.wide_stack} "
            f"entries; the path kernel holds at most {WIDE_STACK} (a deeper "
            "tree than the kernel was built for)")
    check_tables(scene, ("wide_pack", "tri_pack", "tri_shade", "tri_aux",
                         "mat_pack"))
    return scene.wide_pack.data_ptr(), scene.tri_pack.data_ptr()


def pixel_list(pixels, cfg, device) -> torch.Tensor:
    """The caller's pixel list after the checks the kernels need: a 1-D
    integer tensor on `device` of flat indices y * width + x inside the
    cfg.width x cfg.height frame, as int64."""
    if not isinstance(pixels, torch.Tensor) or pixels.dim() != 1 \
            or pixels.dtype.is_floating_point or pixels.dtype == torch.bool:
        raise ValueError("pixels: expected a 1-D integer tensor of flat "
                         "indices y * width + x")
    if pixels.device != torch.device(device):
        raise ValueError(f"pixels on {pixels.device}, the scene on {device}")
    pixels = pixels.to(torch.int64)
    if pixels.numel():
        lo, hi = torch.stack([pixels.min(), pixels.max()]).tolist()
        if lo < 0 or hi >= cfg.width * cfg.height:
            raise ValueError(f"pixels: indices {lo}..{hi} outside the "
                             f"{cfg.width}x{cfg.height} frame")
    return pixels


def tile_order(pixels: torch.Tensor, width: int, tile_w: int,
               tile_h: int) -> torch.Tensor:
    """The permutation that sorts flat pixel indices by (tile_w x tile_h
    tile, lane in tile): a kernel's group of tile_w * tile_h consecutive
    entries is then one tile of the frame wherever the set is dense."""
    x, y = pixels % width, pixels // width
    tiles_x = -(-width // tile_w)
    key = (((y // tile_h) * tiles_x + x // tile_w) * (tile_w * tile_h)
           + (y % tile_h) * tile_w + x % tile_w)
    return torch.argsort(key)


def list_launch(pixels, launch, width: int, tile_w: int, tile_h: int):
    """Run `launch(pix32, n)` on the list ordered by tile_order and
    return its (n, 3) accumulator with row i for pixels[i], and its ray
    count; an empty list launches nothing."""
    n = pixels.numel()
    if n == 0:
        return (torch.zeros((0, 3), dtype=torch.float32,
                            device=pixels.device),
                torch.zeros((), dtype=torch.int64, device=pixels.device))
    order = tile_order(pixels, width, tile_w, tile_h)
    pix32 = pixels[order].to(torch.int32).contiguous()
    accum, nrays = launch(pix32, n)
    out = torch.empty_like(accum)
    out[order] = accum
    return out, nrays


def occupancy(instance: int) -> int:
    """Resident blocks per SM of kernel instance `instance` on the card."""
    lib = build.load()
    n = lib.dsrt_path_occupancy(int(instance))
    if n < 0:
        build.check(lib, -n, "dsrt_path_occupancy")
    return n


def path_render_plain(scene, cam, cfg, spp: int, salt: int = 0,
                      pixels=None):
    """Plain version of the path kernel: for each pixel, the sum over
    `spp` samples of clamp01(L), as (height, width, 3) float32 with row
    0 = the camera's bottom row, and the exact ray count (int64 tensor).
    With `pixels` (flat indices y * width + x) only those pixels, as
    (n, 3) rows in the list's order."""
    if pixels is None:
        return render_samples(scene, cam, cfg, spp, salt)
    pixels = pixel_list(pixels, cfg, scene.device)
    return render_samples(scene, cam, cfg, spp, salt, px=pixels % cfg.width,
                          py=pixels // cfg.width)


def path_render(scene, cam, cfg, spp: int | None = None, salt: int = 0,
                pixels=None):
    """Sum over `spp` samples of clamp01(L) per pixel, (height, width, 3)
    float32, and the exact ray count (int64 tensor).  With `pixels`, a
    1-D integer tensor of flat indices y * width + x on the scene's
    device, only those pixels, as (n, 3) rows in the list's order (the
    TPU kernel's lane set).  CPU scene: the plain version; CUDA scene:
    kernel `dsrt_path_render`, one thread per pixel running every
    sample, in warps that take 8x4 pixel tiles (with a list, 32 list
    entries, the list ordered by tile).  Each call is one `launch` span
    (utils/timing.py) of the active recorder."""
    with timing.span("launch"):
        return _path_render(scene, cam, cfg, spp, salt, pixels)


def _path_render(scene, cam, cfg, spp, salt, pixels):
    spp = cfg.resolved_spp() if spp is None else int(spp)
    if scene.device.type == "cpu":
        return path_render_plain(scene, cam, cfg, spp, salt, pixels)
    require_cuda(scene.device)
    why = scope_error(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    lib = build.load()
    wide, tri = _wide_tables(scene)
    dev = scene.device
    n_tex = int(scene.n_textures)
    for name in ("tex_w", "tex_h", "tex_off"):
        t = getattr(scene, name)
        ptr(t, torch.int32, name)
        if t.numel() < max(n_tex, 1):
            raise ValueError(f"{name}: fewer entries than textures")
    if scene.tri_aux.shape[0] < scene.tri_pack.shape[0]:
        raise ValueError("tri_aux has fewer rows than tri_pack")
    pool = scene.tex_pool
    ptr(pool, torch.float32, "tex_pool")
    params = pack_params(scene)
    if params.numel() != PARAM_LEN:
        raise ValueError(f"parameter vector of {params.numel()} floats, "
                         f"the kernel copies {PARAM_LEN}")
    cam_vec = cam.vector().to(dev).contiguous()
    sun_vec = sun_vector(scene, cfg.shadow_bias)
    # a scene without triangles walks no tree: 0 wide nodes is a miss at
    # once
    n_wide = int(scene.wide_pack.shape[0]) if scene.n_tris > 0 else 0

    def launch(pix, n):
        rows = (n,) if pix is not None else (cfg.height, cfg.width)
        accum = torch.empty(rows + (3,), dtype=torch.float32, device=dev)
        # the ray count, then the kernel's tile counter
        counters = torch.zeros(2, dtype=torch.int64, device=dev)
        rc = lib.dsrt_path_render(
            wide, tri, scene.tri_shade.data_ptr(), scene.tri_aux.data_ptr(),
            scene.mat_pack.data_ptr(), pool.data_ptr(),
            scene.tex_w.data_ptr(), scene.tex_h.data_ptr(),
            scene.tex_off.data_ptr(), ptr(cam_vec, torch.float32, "camera"),
            ptr(sun_vec, torch.float32, "sun"),
            ptr(params, torch.float32, "params"),
            None if pix is None else ptr(pix, torch.int32, "pixels"),
            accum.data_ptr(), counters.data_ptr(),
            int(cfg.width), int(cfg.height), n, int(cam.width),
            int(cam.height), spp, i32(salt), i32(scene.seed),
            int(cfg.resolved_max_depth()), int(cfg.rr_start_depth),
            float(cfg.rr_max_p), float(cfg.hit_eps), float(cfg.hit_tmax),
            n_wide, int(scene.tri_pack.shape[0]), n_tex, int(pool.shape[0]),
            scene.n_spheres, scene.n_quads, scene.n_lights, scene.n_media,
            int(scene.env_tex), flags_of(scene, cfg), instance_of(scene, cfg),
            float(np.float32(scene.env_rotation / (2.0 * np.pi))),
            float(np.float32(scene.env_scale)), float(np.float32(cfg.time0)),
            float(np.float32(cfg.time1 - cfg.time0)),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, rc, "dsrt_path_render")
        LAUNCHES["dsrt_path_render"] += 1
        return accum, counters[0]

    if pixels is None:
        return launch(None, 0)
    return list_launch(pixel_list(pixels, cfg, dev), launch, cfg.width,
                       TILE_W, TILE_H)
