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

The kernels walk the scene's 8-ary table `wide_pack` (csrc/wide_walk.cuh,
whose plain spec `wide_walk_plain` equals `lane_traverse` ray for ray);
a scene whose walk needs a deeper stack than the kernel holds
(`Scene.wide_stack` > WIDE_STACK) takes the binary instance of the same
kernels (csrc/walk.cuh), the same function: `walk_of` is the rule.

Each wrapper takes its plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises.  LAUNCHES counts kernel launches and
INSTANCE_LAUNCHES the launches of each (query, walk) instance.

Any-hit queries return only a hit mask: `tri >= 0` is the contract, and
`t`, `u`, `v` and the row of an any-hit are whatever the walk met first
(the TPU kernel returns the hit's t, `lane_traverse` returns t_min).
"""

from __future__ import annotations

import torch

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.build import (WIDE_STACK, check_tables, ptr,
                                      require_cuda)
from dsrt_tpu_torch.ops.linalg import V3, const, sqrt
from dsrt_tpu_torch.ops.trace import lane_traverse

LAUNCHES = {"dsrt_traverse": 0, "dsrt_traverse_sun": 0}
QUERIES = ("closest", "any", "sun")
WALKS = ("wide", "binary")
INSTANCE_LAUNCHES = {(q, w): 0 for q in QUERIES for w in WALKS}

# Work of one walk step, for the bound the card could reach (PERF.md):
# the slab test is 3 axes x (2 sub + 2 mul + max + min) + the enter
# compare; Moller-Trumbore with precomputed edges is 2 crosses (9 each),
# 4 dots (5 each), the det test (2), one division, the t-vector (3 sub),
# 3 scalings by 1/det and 7 range compares.  The bound counts the binary
# walk's visits and tests whichever walk runs, so it reads the same work.
SLAB_FLOPS = 19
MT_FLOPS = 55
# bytes every lane moves, active or not: the active byte in; t, u, v
# (f32) and the row (int64, as the wrapper returns it) out; +1 blocked
# byte.  An active lane reads its ray too (`ray_bytes`).
LANE_BYTES = 21
SUN_LANE_BYTES = 22
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit)
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


def walk_of(scene) -> str:
    """The walk the kernels take for `scene`: "wide" (the 8-ary walk)
    when its worst stack height fits the kernel's WIDE_STACK entries,
    else "binary" (the stackless walk, any depth)."""
    return "wide" if scene.wide_stack <= WIDE_STACK else "binary"


def _tables(scene, walk: str):
    """(bvh_pack, thr_pack, wide_pack, tri_pack) pointers after the
    checks the walk's instance needs (0 for a table it does not read; the
    wide walk reads the binary root's box in bvh_pack row 0)."""
    if scene.device.type != "cuda":
        raise ValueError(f"scene tables on {scene.device}, expected CUDA")
    if scene.bvh_pack.shape[0] < max(scene.n_nodes, 1):
        raise ValueError("bvh_pack has fewer rows than n_nodes")
    if walk == "wide":
        check_tables(scene, ("bvh_pack", "wide_pack", "tri_pack"))
        return (scene.bvh_pack.data_ptr(), 0, scene.wide_pack.data_ptr(),
                scene.tri_pack.data_ptr())
    check_tables(scene, ("bvh_pack", "thr_pack", "tri_pack"))
    return (scene.bvh_pack.data_ptr(), scene.thr_pack.data_ptr(), 0,
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
                            t_max: float, sun_ldir: V3, shadow_bias: float,
                            walk=lane_traverse):
    """Plain version of `traverse_with_sun`: the closest-hit walk, then an
    any-hit walk toward the sun from `sun_origin` on the hit lanes, both
    by `walk` (the kernel's composition; `wide_walk_plain` gives its wide
    instance's spec)."""
    t, u, v, tri = walk(scene, ro, rd, t_min, t_max, active)
    hit = tri >= 0
    so = sun_origin(scene, ro, rd, t, tri, shadow_bias)
    sd = V3(*(c.to(t.device).expand(t.shape) for c in sun_ldir))
    sh = walk(scene, so, sd, t_min, t_max, hit, any_hit=True)
    return t, u, v, tri, sh[3] >= 0


def sun_vector(sun_ldir: V3, shadow_bias: float) -> torch.Tensor:
    """(Ldir, bias) as f32[4] on Ldir's device, the vector the sun kernel
    reads from device memory (so a launch never waits on the stream);
    a caller makes it once per frame."""
    dev = sun_ldir.x.device
    return torch.stack([sun_ldir.x.to(torch.float32),
                        sun_ldir.y.to(torch.float32),
                        sun_ldir.z.to(torch.float32),
                        const(shadow_bias, dev)])


def _one_value(c) -> bool:
    """Whether a ray component is one value for every ray (0-dim, or
    expanded from one): the kernel reads it from one address."""
    return c.dim() == 0 or (c.numel() > 0 and all(s == 0
                                                  for s in c.stride()))


def _rays(ro: V3, rd: V3, active):
    """Pointers of the six float32 ray components, the tensors that hold
    them, and the bit mask of the components that are one value for
    every ray (`_one_value`); a component of any other layout is copied
    to a contiguous tensor."""
    ptrs, keep, bcast = [], [], 0
    for k, (name, c) in enumerate(zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                                      list(ro) + list(rd))):
        if c.dtype != torch.float32 or c.device != active.device:
            raise ValueError(f"{name}: expected float32 on {active.device}, "
                             f"got {c.dtype} on {c.device}")
        if _one_value(c):
            bcast |= 1 << k
        elif c.shape != active.shape or not c.is_contiguous():
            c = c.expand(active.shape).contiguous()
        ptrs.append(c.data_ptr())
        keep.append(c)
    return ptrs, keep, bcast


def _launch(scene, ro: V3, rd: V3, active, t_min: float, t_max: float,
            query: str, sun=None):
    """Launch the `query` instance of `dsrt_traverse` for the scene's
    walk; returns (t, u, v, tri int64, blocked bool or None) shaped like
    `active`."""
    dev = active.device
    require_cuda(dev)
    if active.dtype != torch.bool:
        raise ValueError(f"active: expected torch.bool, got {active.dtype}")
    lib = build.load()
    walk = walk_of(scene)
    bvh, thr, wide, tri = _tables(scene, walk)
    ptrs, keep, bcast = _rays(ro, rd, active)
    act = active.contiguous()
    n = act.numel()
    if n >= 2 ** 31:
        raise ValueError("too many rays for one launch")
    t = torch.empty(act.shape, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri_out = torch.empty(act.shape, dtype=torch.int64, device=dev)
    blocked = (torch.empty(act.shape, dtype=torch.bool, device=dev)
               if query == "sun" else None)
    # a scene without triangles walks no tree: a miss at once
    n_wide = int(scene.wide_pack.shape[0]) if scene.n_tris > 0 else 0
    name = "dsrt_traverse_sun" if query == "sun" else "dsrt_traverse"
    rc = lib.dsrt_traverse(
        bvh, thr, wide, tri, *ptrs, act.data_ptr(),
        0 if sun is None else ptr(sun, torch.float32, "sun"), t.data_ptr(),
        u.data_ptr(), v.data_ptr(), tri_out.data_ptr(),
        0 if blocked is None else blocked.data_ptr(), n, int(scene.n_nodes),
        n_wide, int(scene.tri_pack.shape[0]), bcast, QUERIES.index(query),
        int(walk == "wide"), float(t_min), float(t_max),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, name)
    LAUNCHES[name] += 1
    INSTANCE_LAUNCHES[(query, walk)] += 1
    return t, u, v, tri_out, blocked


def traverse(scene, ro: V3, rd: V3, active, t_min: float, t_max: float,
             any_hit: bool = False):
    """(t, u, v, tri) per ray of the closest hit (or, with `any_hit`,
    whether any triangle lies in [t_min, t_max]: only `tri >= 0` counts
    then); tri is a tri_pack row, -1 on a miss or an inactive lane (t =
    t_max).  CPU: the plain walk; CUDA: kernel `dsrt_traverse`, one
    thread per ray, on the scene's walk (`walk_of`)."""
    if active.device.type == "cpu":
        return traverse_plain(scene, ro, rd, active, t_min, t_max, any_hit)
    return _launch(scene, ro, rd, active, t_min, t_max,
                   "any" if any_hit else "closest")[:4]


def traverse_with_sun(scene, ro: V3, rd: V3, active, t_min: float,
                      t_max: float, sun_ldir: V3, shadow_bias: float,
                      sun: torch.Tensor | None = None):
    """Closest hit plus the sun-shadow any-hit from the hit point:
    (t, u, v, tri, blocked), `blocked` meaningful on hit lanes only.
    `sun_ldir` is the normalised shadow direction, 0-dim tensors on the
    rays' device; `sun` is `sun_vector(sun_ldir, shadow_bias)` when the
    caller made it once for the frame (else it is made here).  CPU: the
    plain version; CUDA: kernel `dsrt_traverse_sun`, one thread per ray
    running both walks."""
    if active.device.type == "cpu":
        return traverse_with_sun_plain(scene, ro, rd, active, t_min, t_max,
                                       sun_ldir, shadow_bias)
    if sun is None:
        sun = sun_vector(sun_ldir, shadow_bias)
    return _launch(scene, ro, rd, active, t_min, t_max, "sun", sun)


def roofline_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) an H100 could take for `flops` float32 operations
    and `nbytes` of device-memory traffic, and which of the two bounds
    it: FLOPs over 67 TFLOP/s (f32 outside the tensor cores), bytes over
    3.35 TB/s."""
    t_f, t_b = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_f, "operations") if t_f > t_b else (t_b, "bytes")


def ray_bytes(ro: V3, rd: V3, n_active: int) -> int:
    """Bytes of the rays the kernel reads: each component once an active
    ray, or once in all where it is one value for every ray (the shadow
    query's sun direction).  An inactive lane reads no ray."""
    return sum(4 if _one_value(c) else 4 * n_active for c in (*ro, *rd))


def bound_ms(scene, lanes: int, rays_in: int, visits: int, tests: int,
             with_sun: bool = False) -> tuple[float, str]:
    """roofline_ms of a traversal call on `lanes` lanes: `rays_in` is
    `ray_bytes` of its rays, `visits` and `tests` the walk's node visits
    and triangle tests on these inputs (trace.walk_counter); each lane
    moves LANE_BYTES (SUN_LANE_BYTES and the 16-byte sun vector with
    the sun query), each table is read once."""
    flops = visits * SLAB_FLOPS + tests * MT_FLOPS
    tables = sum(getattr(scene, k).numel() * 4
                 for k in ("bvh_pack", "thr_pack", "tri_pack"))
    lane = SUN_LANE_BYTES if with_sun else LANE_BYTES
    return roofline_ms(flops, lanes * lane + rays_in + 16 * with_sun
                       + tables)
