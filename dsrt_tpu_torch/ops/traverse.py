"""Wrappers of the split pipeline's traversal kernels
(csrc/traverse_kernel.cu), their plain PyTorch versions, and launch
counters.

Port of dsrt_tpu/ops/pallas_trace.py: `traverse` (:476, kernel
`_traverse_kernel` :386 over `_kernel_common` :128) and
`traverse_with_sun` (:550, kernel `_traverse_sun_kernel` :399).  The TPU
kernels walk one octant per 1024-ray block, picked by majority vote; that
choice changes only the visit order, which decides only exact `t` ties.
The CUDA kernels walk each ray's own octant, as `lane_traverse` does, so
the plain versions are `lane_traverse` itself and results are equal ray
for ray.

Each wrapper takes its plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises.  LAUNCHES counts kernel launches.

Any-hit queries return only a hit mask: `tri >= 0` is the contract, and
`t`, `u`, `v` and the row of an any-hit are whatever the walk met first
(the TPU kernel returns the hit's t, `lane_traverse` returns t_min).
"""

from __future__ import annotations

import torch

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.linalg import V3, const, sqrt
from dsrt_tpu_torch.ops.path_kernel import _ptr, _require_cuda
from dsrt_tpu_torch.ops.trace import lane_traverse

LAUNCHES = {"dsrt_traverse": 0, "dsrt_traverse_sun": 0}

# Work of one walk step, for the bound the card could reach (PERF.md):
# the slab test is 3 axes x (2 sub + 2 mul + max + min) + the enter
# compare; Moller-Trumbore with precomputed edges is 2 crosses (9 each),
# 4 dots (5 each), the det test (2), one division, the t-vector (3 sub),
# 3 scalings by 1/det and 7 range compares.
SLAB_FLOPS = 19
MT_FLOPS = 55
# bytes a ray moves in and out: origin, direction (f32 x 6) and the
# active byte in; t, u, v (f32) and the row (i32) out; +1 blocked byte
RAY_BYTES = 41
SUN_RAY_BYTES = 42
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit)
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tables(scene):
    """(bvh_pack, thr_pack, tri_pack) pointers after the checks the
    traversal kernels need."""
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"scene tables on {dev}, expected CUDA")
    for name in ("bvh_pack", "thr_pack", "tri_pack", "tri_shade",
                 "tri_aux", "mat_pack"):
        t = getattr(scene, name)
        _ptr(t, torch.float32, name)
        if t.dim() != 2 or t.shape[1] != 16:
            raise ValueError(f"{name}: expected (rows, 16), got "
                             f"{tuple(t.shape)}")
    if scene.bvh_pack.shape[0] < scene.n_nodes:
        raise ValueError("bvh_pack has fewer rows than n_nodes")
    return (scene.bvh_pack.data_ptr(), scene.thr_pack.data_ptr(),
            scene.tri_pack.data_ptr())


def traverse_plain(scene, ro: V3, rd: V3, active, t_min: float,
                   t_max: float, any_hit: bool = False):
    """Plain version of `traverse`: the per-lane walk (ops/trace.py)."""
    return lane_traverse(scene, ro, rd, t_min, t_max, active,
                         any_hit=any_hit)


def sun_origin(scene, ro: V3, rd: V3, t, tri, shadow_bias: float) -> V3:
    """Shadow-ray origin o + t d + bias n of a closest hit, n the
    face-flipped geometric normal e1 x e2 / sqrt(|e1 x e2|^2 + 1e-38) of
    the winning row (pallas_trace.py:248-260, :298-301), added in that
    order."""
    tp = scene.tri_pack[torch.clamp(tri, 0, scene.tri_pack.shape[0] - 1)]
    e1x, e1y, e1z = tp[..., 3], tp[..., 4], tp[..., 5]
    e2x, e2y, e2z = tp[..., 6], tp[..., 7], tp[..., 8]
    gx = e1y * e2z - e1z * e2y
    gy = e1z * e2x - e1x * e2z
    gz = e1x * e2y - e1y * e2x
    gl = 1.0 / sqrt(gx * gx + gy * gy + gz * gz + 1e-38)
    gx, gy, gz = gx * gl, gy * gl, gz * gl
    sgn = torch.where(rd.x * gx + rd.y * gy + rd.z * gz < 0.0, 1.0, -1.0)
    bias = float(shadow_bias)
    return V3(ro.x + t * rd.x + bias * (sgn * gx),
              ro.y + t * rd.y + bias * (sgn * gy),
              ro.z + t * rd.z + bias * (sgn * gz))


def traverse_with_sun_plain(scene, ro: V3, rd: V3, active, t_min: float,
                            t_max: float, sun_ldir: V3, shadow_bias: float):
    """Plain version of `traverse_with_sun`: the closest-hit walk, then an
    any-hit walk toward the sun from `sun_origin` on the hit lanes."""
    t, u, v, tri = lane_traverse(scene, ro, rd, t_min, t_max, active)
    hit = tri >= 0
    so = sun_origin(scene, ro, rd, t, tri, shadow_bias)
    sd = V3(*(c.to(t.device).expand(t.shape) for c in sun_ldir))
    sh = lane_traverse(scene, so, sd, t_min, t_max, hit, any_hit=True)
    return t, u, v, tri, sh[3] >= 0


def _rays(ro: V3, rd: V3, active):
    """Pointers of the flat contiguous float32 ray components, the tensors
    that hold them, and the active bytes."""
    comps = []
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       list(ro) + list(rd)):
        if c.dtype != torch.float32 or c.device != active.device:
            raise ValueError(f"{name}: expected float32 on {active.device}, "
                             f"got {c.dtype} on {c.device}")
        comps.append(c.expand(active.shape).reshape(-1).contiguous())
    act = active.reshape(-1).to(torch.uint8).contiguous()
    return [c.data_ptr() for c in comps], comps, act


def _outputs(n: int, device):
    t = torch.empty(n, dtype=torch.float32, device=device)
    return (t, torch.empty_like(t), torch.empty_like(t),
            torch.empty(n, dtype=torch.int32, device=device))


def _launch_common(scene, ro: V3, rd: V3, active):
    dev = active.device
    _require_cuda(dev)
    if active.dtype != torch.bool:
        raise ValueError(f"active: expected torch.bool, got {active.dtype}")
    lib = build.load()
    tables = _tables(scene)
    ptrs, keep, act = _rays(ro, rd, active)
    n = act.numel()
    if n >= 2 ** 31:
        raise ValueError("too many rays for one launch")
    return lib, tables, ptrs, keep, act, n


def traverse(scene, ro: V3, rd: V3, active, t_min: float, t_max: float,
             any_hit: bool = False):
    """(t, u, v, tri) per ray of the closest hit (or, with `any_hit`,
    whether any triangle lies in [t_min, t_max]: only `tri >= 0` counts
    then); tri is a tri_pack row, -1 on a miss or an inactive lane (t =
    t_max).  CPU: the plain walk; CUDA: kernel `dsrt_traverse`, one
    thread per ray."""
    if active.device.type == "cpu":
        return traverse_plain(scene, ro, rd, active, t_min, t_max, any_hit)
    lib, (bvh, thr, tri), ptrs, keep, act, n = _launch_common(
        scene, ro, rd, active)
    t, u, v, tri_out = _outputs(n, act.device)
    rc = lib.dsrt_traverse(
        bvh, thr, tri, *ptrs, act.data_ptr(), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), tri_out.data_ptr(), n, int(scene.n_nodes),
        int(scene.tri_pack.shape[0]), int(bool(any_hit)), float(t_min),
        float(t_max), torch.cuda.current_stream(act.device).cuda_stream)
    build.check(lib, rc, "dsrt_traverse")
    LAUNCHES["dsrt_traverse"] += 1
    shape = active.shape
    return (t.reshape(shape), u.reshape(shape), v.reshape(shape),
            tri_out.to(torch.int64).reshape(shape))


def traverse_with_sun(scene, ro: V3, rd: V3, active, t_min: float,
                      t_max: float, sun_ldir: V3, shadow_bias: float):
    """Closest hit plus the sun-shadow any-hit from the hit point:
    (t, u, v, tri, blocked), `blocked` meaningful on hit lanes only.
    `sun_ldir` is the normalised shadow direction, 0-dim tensors on the
    rays' device (the kernel reads them with the bias from device memory,
    so the launch never waits on the stream).  CPU: the plain version;
    CUDA: kernel `dsrt_traverse_sun`, one thread per ray running both
    walks."""
    if active.device.type == "cpu":
        return traverse_with_sun_plain(scene, ro, rd, active, t_min, t_max,
                                       sun_ldir, shadow_bias)
    lib, (bvh, thr, tri), ptrs, keep, act, n = _launch_common(
        scene, ro, rd, active)
    t, u, v, tri_out = _outputs(n, act.device)
    blocked = torch.empty(n, dtype=torch.uint8, device=act.device)
    sun = torch.stack([sun_ldir.x, sun_ldir.y, sun_ldir.z,
                       const(shadow_bias, act.device)]).to(torch.float32)
    rc = lib.dsrt_traverse_sun(
        bvh, thr, tri, *ptrs, act.data_ptr(), _ptr(sun, torch.float32, "sun"),
        t.data_ptr(), u.data_ptr(), v.data_ptr(), tri_out.data_ptr(),
        blocked.data_ptr(), n, int(scene.n_nodes),
        int(scene.tri_pack.shape[0]), float(t_min), float(t_max),
        torch.cuda.current_stream(act.device).cuda_stream)
    build.check(lib, rc, "dsrt_traverse_sun")
    LAUNCHES["dsrt_traverse_sun"] += 1
    shape = active.shape
    return (t.reshape(shape), u.reshape(shape), v.reshape(shape),
            tri_out.to(torch.int64).reshape(shape),
            blocked.to(torch.bool).reshape(shape))


def roofline_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) an H100 could take for `flops` float32 operations
    and `nbytes` of device-memory traffic, and which of the two bounds
    it: FLOPs over 67 TFLOP/s (f32 outside the tensor cores), bytes over
    3.35 TB/s."""
    t_f, t_b = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_f, "operations") if t_f > t_b else (t_b, "bytes")


def bound_ms(scene, n_rays: int, visits: int, tests: int,
             with_sun: bool = False) -> tuple[float, str]:
    """roofline_ms of a traversal call: `visits` and `tests` are the
    walk's node visits and triangle tests on these inputs
    (trace.walk_counter); each ray moves in and out once, each table is
    read once."""
    flops = visits * SLAB_FLOPS + tests * MT_FLOPS
    tables = sum(getattr(scene, k).numel() * 4
                 for k in ("bvh_pack", "thr_pack", "tri_pack"))
    return roofline_ms(flops, n_rays * (SUN_RAY_BYTES if with_sun
                                        else RAY_BYTES) + tables)
