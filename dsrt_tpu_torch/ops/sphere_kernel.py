"""Wrapper of the CUDA kernel in csrc/sphere_kernel.cu, its plain PyTorch
version, and its launch counter.

Port of dsrt_tpu/ops/pallas_sphere.py: `sphere_fused_supported` (:69-81,
without the TPU check) and the frame entry `trace_fused_spheres`
(:723-858).  The wrapper packs the scene's part of the kernel's parameter
vector once per scene and sun (`scene_params`, kept in `Scene.cache`) and
passes the camera vector beside it; the kernel copies both into its
constant bank.  It takes the plain version only for a scene on the CPU;
for a CUDA scene it launches `dsrt_sphere_render` or raises.
LAUNCHES counts kernel launches, so a caller can show a run went through
the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.path_kernel import _cached, _i32, _ptr, _require_cuda
from dsrt_tpu_torch.ops.shade import (MAX_LIGHTS, MAX_MED, MAX_SPH,
                                      check_scope, render_samples,
                                      sun_direction)

LAUNCHES = {"dsrt_sphere_render": 0}
# floats in the parameter vector: spheres (8 each), media (15 each),
# lights (4 each), camera (19), sun (8) — csrc/sphere_kernel.cu `Params`
PARAM_LEN = 8 * MAX_SPH + 15 * MAX_MED + 4 * MAX_LIGHTS + 19 + 8
CAM_AT = 8 * MAX_SPH + 15 * MAX_MED + 4 * MAX_LIGHTS   # the camera's slot
MAX_MATS = 768   # material rows in the kernel's 48 KB of shared memory
# flag bits of the kernel's `flags` argument
SUN_ON, PTEX, APERTURE, SHUTTER, MOVING = 1, 2, 4, 8, 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scope_error(scene, cfg) -> str | None:
    """Why the sphere kernel does not cover this scene, or None.  It
    covers scenes of 1-16 spheres and nothing else of geometry, up to 4
    media and 8 sphere lights, procedural textures and the environment
    sky, with any camera and shutter."""
    try:
        check_scope(scene, cfg)
    except NotImplementedError as e:
        return str(e)
    if scene.n_tris or scene.n_quads or scene.has_image_tex:
        return "the sphere kernel takes sphere-only scenes"
    if scene.n_spheres == 0:
        return "the sphere kernel needs at least one sphere"
    if scene.mat_pack.shape[0] > MAX_MATS:
        return f"the sphere kernel takes at most {MAX_MATS} materials"
    return None


def occupancy(n_mats: int) -> int:
    """Resident blocks per SM of the sphere kernel with `n_mats` material
    rows in shared memory, on the card."""
    lib = build.load()
    n = lib.dsrt_sphere_occupancy(int(n_mats))
    if n < 0:
        build.check(lib, -n, "dsrt_sphere_occupancy")
    return n


def sphere_fused_supported(scene, cfg) -> bool:
    """Whether the sphere kernel covers this scene and config."""
    return scope_error(scene, cfg) is None


def _param_sources(scene) -> tuple:
    return (scene.sph_center, scene.sph_center2, scene.sph_radius,
            scene.sph_mat, scene.light_idx, scene.med_kind, scene.med_center,
            scene.med_radius, scene.med_min, scene.med_max,
            scene.med_neg_inv_density, scene.med_albedo, scene.sun_dir,
            scene.sun_radiance)


def _pack_scene(scene, shadow_bias: float) -> torch.Tensor:
    def host(t):
        return t.detach().cpu().numpy()

    ns, nm, nl = scene.n_spheres, scene.n_media, scene.n_lights
    sph = np.zeros((MAX_SPH, 8), np.float32)
    sph[:ns, 0:3] = host(scene.sph_center)[:ns]
    sph[:ns, 3] = host(scene.sph_radius)[:ns]
    sph[:ns, 4] = host(scene.sph_mat)[:ns]
    sph[:ns, 5:8] = host(scene.sph_center2)[:ns]
    med = np.zeros((MAX_MED, 15), np.float32)
    if nm:
        med[:nm, 0] = host(scene.med_kind)[:nm]
        med[:nm, 1:4] = host(scene.med_center)[:nm]
        med[:nm, 4] = host(scene.med_radius)[:nm]
        med[:nm, 5:8] = host(scene.med_min)[:nm]
        med[:nm, 8:11] = host(scene.med_max)[:nm]
        med[:nm, 11] = host(scene.med_neg_inv_density)[:nm]
        med[:nm, 12:15] = host(scene.med_albedo)[:nm]
    lit = np.zeros((MAX_LIGHTS, 4), np.float32)
    if nl:
        li = host(scene.light_idx)[:nl].astype(np.int64)
        lit[:nl, 0:3] = host(scene.sph_center)[li]
        lit[:nl, 3] = host(scene.sph_radius)[li]
    sun = np.zeros(8, np.float32)
    sun[0:3] = [float(c) for c in sun_direction(scene)]
    sun[3:6] = host(scene.sun_radiance)
    sun[6] = shadow_bias
    flat = np.concatenate([sph.ravel(), med.ravel(), lit.ravel(),
                           np.zeros(19, np.float32), sun])
    return torch.as_tensor(flat, device=scene.device)


def scene_params(scene, cfg) -> torch.Tensor:
    """The kernel's parameter vector but for the camera (its slot zero,
    which the launch fills from the camera vector), f32[PARAM_LEN] on
    the scene's device: per sphere c0, radius, material, c2; per medium
    kind, centre, radius, box min and max, -1/density, albedo; per light
    its sphere's c0 and radius; the camera's 19 floats; Ldir (normalised
    on the host by a reciprocal multiply, as the plain version does), sun
    radiance and shadow bias.  Packed on the host once per scene, sun and
    shadow bias."""
    bias = float(cfg.shadow_bias)
    return _cached(scene, f"sphere_params {bias!r}", _param_sources(scene),
                   lambda: _pack_scene(scene, bias))


def launch_scalars(scene, cam, cfg, spp: int, salt: int = 0):
    """The kernel's int and float arguments, in the order of its C
    signature (ops/build.py SIGNATURES)."""
    flags = ((SUN_ON if scene.sun_enabled else 0)
             | (PTEX if scene.has_ptex else 0)
             | (APERTURE if cfg.aperture > 0 else 0))
    if cfg.time1 > cfg.time0:
        # the shutter draw happens with the shutter open, moving spheres
        # or not; the centre lerp only with moving spheres
        flags |= SHUTTER | (MOVING if scene.has_moving else 0)
    ints = [int(cfg.width), int(cfg.height), int(cam.width), int(cam.height),
            int(spp), _i32(salt), _i32(scene.seed),
            int(cfg.resolved_max_depth()), int(cfg.rr_start_depth),
            int(scene.mat_pack.shape[0]), scene.n_spheres, scene.n_media,
            scene.n_lights, int(scene.env_tex), int(scene.n_textures),
            int(scene.tex_pool.shape[0]), flags]
    floats = [float(cfg.rr_max_p), float(cfg.hit_eps), float(cfg.hit_tmax),
              float(np.float32(scene.env_rotation / (2.0 * np.pi))),
              float(np.float32(scene.env_scale)), float(np.float32(cfg.time0)),
              float(np.float32(cfg.time1 - cfg.time0))]
    return ints, floats


def sphere_render_plain(scene, cam, cfg, spp: int, salt: int = 0):
    """Plain version of the sphere kernel: for each pixel, the sum over
    `spp` samples of clamp01(L), as (height, width, 3) float32 with row
    0 = the camera's bottom row, and the exact ray count (int64 tensor).
    Runs on the scene's device."""
    why = scope_error(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    return render_samples(scene, cam, cfg, spp, salt)


def sphere_render(scene, cam, cfg, spp: int | None = None, salt: int = 0):
    """Sum over `spp` samples of clamp01(L) per pixel, (height, width, 3)
    float32, and the exact ray count (int64 tensor).  CPU scene: the
    plain version; CUDA scene: kernel `dsrt_sphere_render`, one thread
    per pixel running every sample."""
    spp = cfg.resolved_spp() if spp is None else int(spp)
    if scene.device.type == "cpu":
        return sphere_render_plain(scene, cam, cfg, spp, salt)
    _require_cuda(scene.device)
    why = scope_error(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    lib = build.load()
    dev = scene.device
    params = scene_params(scene, cfg)
    cam_vec = cam.vector().to(dev)
    if params.numel() != PARAM_LEN or cam_vec.numel() != 19:
        raise ValueError(f"parameter vector of {params.numel()} floats and "
                         f"camera of {cam_vec.numel()}, the kernel copies "
                         f"{PARAM_LEN} and 19")
    mat = scene.mat_pack
    if mat.dim() != 2 or mat.shape[1] != 16:
        raise ValueError(f"mat_pack: expected (rows, 16), got "
                         f"{tuple(mat.shape)}")
    for name in ("tex_w", "tex_h", "tex_off"):
        if getattr(scene, name).numel() < max(scene.n_textures, 1):
            raise ValueError(f"{name}: fewer entries than textures")
    ints, floats = launch_scalars(scene, cam, cfg, spp, salt)
    accum = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=dev)
    nrays = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = lib.dsrt_sphere_render(
        _ptr(params, torch.float32, "params"),
        _ptr(cam_vec, torch.float32, "camera"),
        _ptr(mat, torch.float32, "mat_pack"),
        _ptr(scene.tex_pool, torch.float32, "tex_pool"),
        _ptr(scene.tex_w, torch.int32, "tex_w"),
        _ptr(scene.tex_h, torch.int32, "tex_h"),
        _ptr(scene.tex_off, torch.int32, "tex_off"),
        accum.data_ptr(), nrays.data_ptr(), *ints, *floats,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "dsrt_sphere_render")
    LAUNCHES["dsrt_sphere_render"] += 1
    return accum, nrays[0]
