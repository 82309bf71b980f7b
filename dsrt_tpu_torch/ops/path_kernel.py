"""Wrappers of the CUDA kernels in csrc/path_kernel.cu, their plain
PyTorch versions, and launch counters.

Port of dsrt_tpu/ops/pallas_path.py for the triangle scope
(`fused_supported`, :101-133, as `scope_error`) and the frame entry
`trace_fused` (:3684-3938).  Each wrapper takes its plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or
raises.  LAUNCHES counts kernel launches, so a caller can show a run went
through the kernels.
"""

from __future__ import annotations

import torch

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.linalg import V3
from dsrt_tpu_torch.ops.shade import (check_scope, render_samples,
                                      sun_direction)
from dsrt_tpu_torch.ops.trace import lane_traverse

LAUNCHES = {"dsrt_path_render": 0, "dsrt_closest_hit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scope_error(scene, cfg) -> str | None:
    """Why the path kernel does not cover this scene and config, or None.
    It covers triangle scenes with flat normals, image textures and the
    sun on or off; no spheres, quads, area lights, media, env sky,
    procedural textures, depth of field or motion blur."""
    try:
        check_scope(scene, cfg)
    except NotImplementedError as e:
        return str(e)
    if scene.n_tris == 0:
        return "the path kernel needs a triangle scene"
    if (scene.n_spheres or scene.n_lights or scene.n_media
            or scene.env_tex >= 0 or scene.has_ptex):
        return ("spheres, area lights, media, the environment sky and "
                "procedural textures in a triangle scene are not ported "
                "yet (ROADMAP queue 1 item 1)")
    if cfg.aperture > 0 or cfg.time1 > cfg.time0:
        return ("depth of field and motion blur in a triangle scene are "
                "not ported yet (ROADMAP queue 1 item 1)")
    return None


def _i32(x: int) -> int:
    """A uint32 value as the signed int ctypes passes."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: the kernels take CUDA "
                         "tensors, the plain versions CPU tensors")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA tensors but no CUDA device is available")


def _ptr(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    return t.data_ptr()


def _tables(scene):
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"scene tables on {dev}, expected CUDA")
    for name in ("bvh_pack", "thr_pack", "tri_pack", "tri_shade",
                 "mat_pack"):
        t = getattr(scene, name)
        _ptr(t, torch.float32, name)
        if t.dim() != 2 or t.shape[1] != 16:
            raise ValueError(f"{name}: expected (rows, 16), got "
                             f"{tuple(t.shape)}")
    if scene.bvh_pack.shape[0] < scene.n_nodes:
        raise ValueError("bvh_pack has fewer rows than n_nodes")
    return (scene.bvh_pack.data_ptr(), scene.thr_pack.data_ptr(),
            scene.tri_pack.data_ptr())


def closest_hit_plain(scene, ro: V3, rd: V3, t_min: float, t_max: float):
    active = torch.ones(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    return lane_traverse(scene, ro, rd, t_min, t_max, active)


def closest_hit(scene, ro: V3, rd: V3, t_min: float = 1e-3,
                t_max: float = 1e9):
    """(t, u, v, tri) of the closest hit per ray.  CPU: the plain walk;
    CUDA: kernel `dsrt_closest_hit`, one thread per ray."""
    if ro.x.device.type == "cpu":
        return closest_hit_plain(scene, ro, rd, t_min, t_max)
    _require_cuda(ro.x.device)
    lib = build.load()
    bvh, thr, tri = _tables(scene)
    shape = ro.x.shape
    o = torch.stack([c.reshape(-1) for c in ro], dim=1).contiguous()
    d = torch.stack([c.reshape(-1) for c in rd], dim=1).contiguous()
    n = o.shape[0]
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("rays must be float32")
    if n >= 2 ** 31:
        raise ValueError("too many rays for one launch")
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    tri_out = torch.empty(n, dtype=torch.int32, device=o.device)
    rc = lib.dsrt_closest_hit(
        bvh, thr, tri, _ptr(o, torch.float32, "ro"),
        _ptr(d, torch.float32, "rd"), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), tri_out.data_ptr(), n, int(scene.n_nodes),
        int(scene.tri_pack.shape[0]), float(t_min), float(t_max),
        torch.cuda.current_stream(o.device).cuda_stream)
    build.check(lib, rc, "dsrt_closest_hit")
    LAUNCHES["dsrt_closest_hit"] += 1
    return (t.reshape(shape), u.reshape(shape), v.reshape(shape),
            tri_out.to(torch.int64).reshape(shape))


def path_render_plain(scene, cam, cfg, spp: int, salt: int = 0):
    """Plain version of the path kernel: for each pixel, the sum over
    `spp` samples of clamp01(L), as (height, width, 3) float32 with row
    0 = the camera's bottom row, and the exact ray count (int64 tensor)."""
    return render_samples(scene, cam, cfg, spp, salt)


def path_render(scene, cam, cfg, spp: int | None = None, salt: int = 0):
    """Sum over `spp` samples of clamp01(L) per pixel, (height, width, 3)
    float32, and the exact ray count (int64 tensor).  CPU scene: the
    plain version; CUDA scene: kernel `dsrt_path_render`, one thread per
    pixel running every sample."""
    spp = cfg.resolved_spp() if spp is None else int(spp)
    if scene.device.type == "cpu":
        return path_render_plain(scene, cam, cfg, spp, salt)
    _require_cuda(scene.device)
    why = scope_error(scene, cfg)
    if why is not None:
        raise NotImplementedError(why)
    lib = build.load()
    bvh, thr, tri = _tables(scene)
    dev = scene.device
    n_tex = int(scene.n_textures)
    for name in ("tex_w", "tex_h", "tex_off"):
        t = getattr(scene, name)
        _ptr(t, torch.int32, name)
        if t.numel() < max(n_tex, 1):
            raise ValueError(f"{name}: fewer entries than textures")
    pool = scene.tex_pool
    _ptr(pool, torch.float32, "tex_pool")
    cam_vec = cam.vector().to(dev).contiguous()
    sd = sun_direction(scene)
    sun_vec = torch.tensor(
        [float(c) for c in sd] + [float(c) for c in scene.sun_radiance]
        + [float(cfg.shadow_bias)], dtype=torch.float32, device=dev)
    accum = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=dev)
    nrays = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = lib.dsrt_path_render(
        bvh, thr, tri, scene.tri_shade.data_ptr(), scene.mat_pack.data_ptr(),
        pool.data_ptr(), scene.tex_w.data_ptr(), scene.tex_h.data_ptr(),
        scene.tex_off.data_ptr(), cam_vec.data_ptr(), sun_vec.data_ptr(),
        accum.data_ptr(), nrays.data_ptr(),
        int(cfg.width), int(cfg.height), int(cam.width), int(cam.height),
        spp, _i32(salt), _i32(scene.seed), int(cfg.resolved_max_depth()),
        int(cfg.rr_start_depth), float(cfg.rr_max_p), float(cfg.hit_eps),
        float(cfg.hit_tmax), int(scene.n_nodes),
        int(scene.tri_pack.shape[0]), n_tex,
        int(pool.shape[0]), int(bool(scene.sun_enabled)),
        int(bool(scene.has_image_tex)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "dsrt_path_render")
    LAUNCHES["dsrt_path_render"] += 1
    return accum, nrays[0]
