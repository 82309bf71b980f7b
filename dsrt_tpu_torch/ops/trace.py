"""Plain scene intersection: the per-ray stackless BVH walk, the sphere,
quad and constant-medium passes, and hit assembly.

Port of dsrt_tpu/ops/trace.py:465-590 (`lane_traverse`), :652-683
(`hit_from_kernel`), :611-630 (smooth normals), :258-319 (`sphere_pass`),
:322-380 (`quad_pass`), :383-462 (`_boundary_interval`, `media_pass`) and
:603-649 (`scene_hit_flat_lane`, `scene_hit`).  Every
ray walks the octant thread table on its own: octant o = (dx<0) +
2(dy<0) + 4(dz<0); an entered interior node continues at thr[node, 2o]
(the near child), anything else at thr[node, 2o+1] (the next node after
the subtree).  Leaves are scanned in
row order with `<=` acceptance against the running closest t, so ties go
to the later row — the walk order, and hence the accepted triangle, is
the reference's.  The CUDA kernels (csrc/walk.cuh) walk the same way.

On smooth (vn) scenes the walk's winner takes the barycentric blend of
its vertex normals (tri_aux), normalised by 1 / max(len, 1e-38), and its
`front` from that shading normal.  Spheres, then quads, are tested one
after another after the walk, accepting t <= closest, so a primitive
wins a tie with a triangle and a later primitive a tie with an earlier
one; with a per-lane shutter time a moving centre is c0 + t (c2 - c0).
A quad hit is the plane hit (|n . d| >= 1e-8) with both coordinates
alpha = w . (p x v), beta = w . (u x p) in [0, 1].  Each medium then
draws once on every active lane of every query (shadow queries included)
and scatters where the free path -log(u) / density ends inside its
boundary interval and before the nearest surface.

This is the plain version: rays are vectorised, and each step works on
the rays still walking (compacted), so it runs on CPU or CUDA tensors.
`walk_counter` counts its node visits and triangle tests, and the
sphere, quad and medium tests of the primitive passes: the work from
which PERF.md bounds the kernels.

`scene_hit_flat` and `scene_hit_flat_sun` (JAX :686-725) are the split
pipeline's queries: the triangle walk goes through the traversal kernels
of ops/traverse.py (their plain versions for CPU tensors).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops.linalg import V3, const, dot, f64_op, sqrt


class Hit(NamedTuple):
    hit: torch.Tensor      # bool
    t: torch.Tensor
    nx: torch.Tensor       # face-flipped flat normal
    ny: torch.Tensor
    nz: torch.Tensor
    front: torch.Tensor    # bool
    mat: torch.Tensor      # int64 material row
    tex: torch.Tensor      # int64 texture id (-1 none)
    tri: torch.Tensor      # int64 tri_pack row (-1 miss)
    u: torch.Tensor
    v: torch.Tensor
    tu: torch.Tensor       # interpolated texture coordinates
    tv: torch.Tensor
    medium: torch.Tensor   # int64 medium index (-1: a surface hit)

    @property
    def normal(self) -> V3:
        return V3(self.nx, self.ny, self.nz)


_COUNTS: dict | None = None


@contextlib.contextmanager
def walk_counter():
    """Count the plain walk's node visits and triangle tests, and the
    sphere, quad and medium tests (one per active ray and primitive),
    inside the block, and `wide_walk_plain`'s wide node visits and
    triangle tests: yields a dict {"visits", "tests", "spheres", "quads",
    "media", "wide_visits", "wide_tests"}; read each with int() (counts
    stay on the device until then)."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, {"visits": 0, "tests": 0, "spheres": 0,
                              "quads": 0, "media": 0, "wide_visits": 0,
                              "wide_tests": 0}
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def _leaf_scan(tp, o, d, t_min, closest, cnt, any_hit: bool):
    """Moller-Trumbore over one leaf per ray: tp (m, L, 16) rows, rays
    (m, 1).  Returns (accepted?, winning slot, t, u, v) per ray with the
    sequential `<=` semantics of the row-order scan."""
    e1x, e1y, e1z = tp[..., 3], tp[..., 4], tp[..., 5]
    e2x, e2y, e2z = tp[..., 6], tp[..., 7], tp[..., 8]
    ox, oy, oz = o
    dx, dy, dz = d
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvx = ox - tp[..., 0]
    tvy = oy - tp[..., 1]
    tvz = oz - tp[..., 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    slots = torch.arange(tp.shape[1], device=tp.device)
    ok = ok & (t >= t_min) & (slots[None, :] < cnt[:, None])
    cand = ok & (t <= closest[:, None])
    big = tp.shape[1]
    if any_hit:
        # the first candidate collapses the interval to t_min; later rows
        # are accepted only at exactly t == t_min
        first = torch.where(cand, slots, big).amin(dim=1)
        again = ok & (t == t_min) & (slots[None, :] > first[:, None])
        last = torch.where(again, slots, -1).amax(dim=1)
        win = torch.where(last >= 0, last, first)
    else:
        # the sequential scan ends on the LAST row holding the minimum t
        tm = torch.where(cand, t, torch.full_like(t, float("inf")))
        tbest = tm.amin(dim=1, keepdim=True)
        win = torch.where(cand & (t == tbest), slots, -1).amax(dim=1)
    hit = cand.any(dim=1)
    win = torch.where(hit, win, 0)[:, None]
    return (hit, win[:, 0], t.gather(1, win)[:, 0], u.gather(1, win)[:, 0],
            v.gather(1, win)[:, 0])


def lane_traverse(scene, ro: V3, rd: V3, t_min: float, t_max: float,
                  active: torch.Tensor, any_hit: bool = False):
    """Closest (or any) hit per ray; returns (t, u, v, tri) with `tri` a
    tri_pack row (-1 = miss, t = t_max)."""
    shape = ro.x.shape
    dev = ro.x.device
    o = [c.reshape(-1).to(torch.float32) for c in ro]
    d = [c.reshape(-1).to(torch.float32) for c in rd]
    act = active.reshape(-1)
    n = act.numel()
    end = int(scene.n_nodes)
    tmin_f = torch.tensor(t_min, dtype=torch.float32, device=dev)
    tmax_f = torch.tensor(t_max, dtype=torch.float32, device=dev)
    inv = [1.0 / c for c in d]
    octant = ((d[0] < 0).to(torch.int64) + 2 * (d[1] < 0).to(torch.int64)
              + 4 * (d[2] < 0).to(torch.int64))
    thr_flat = scene.thr_pack.reshape(-1)
    bvh = scene.bvh_pack
    tri_pack = scene.tri_pack
    max_leaf = int(scene.max_leaf)
    leaf_slots = torch.arange(max_leaf, device=dev)

    closest = torch.where(act, tmax_f, tmin_f)
    uu = torch.zeros(n, dtype=torch.float32, device=dev)
    vv = torch.zeros(n, dtype=torch.float32, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    node = torch.where(act & (scene.n_tris > 0), 0, end).to(torch.int64)

    idx = torch.nonzero(node < end).reshape(-1)
    while idx.numel():
        nd = node[idx]
        nf = bvh[nd]
        oo = [c[idx] for c in o]
        ii = [c[idx] for c in inv]
        cl = closest[idx]
        tmin_c = tmin_f.expand(idx.shape)
        tmax_c = cl
        for a in range(3):
            t0 = (nf[:, a] - oo[a]) * ii[a]
            t1 = (nf[:, 3 + a] - oo[a]) * ii[a]
            neg = ii[a] < 0.0
            tmin_c = torch.maximum(tmin_c, torch.where(neg, t1, t0))
            tmax_c = torch.minimum(tmax_c, torch.where(neg, t0, t1))
        enter = tmax_c > tmin_c
        cnt = nf[:, 8].to(torch.int64)
        is_leaf = cnt > 0
        at_leaf = enter & is_leaf
        if _COUNTS is not None:
            _COUNTS["visits"] = _COUNTS["visits"] + idx.numel()
            _COUNTS["tests"] = _COUNTS["tests"] + torch.where(
                at_leaf, cnt, 0).sum()

        li = torch.nonzero(at_leaf).reshape(-1)
        if li.numel():
            rows = nf[li, 7].to(torch.int64)[:, None] + leaf_slots[None, :]
            tp = tri_pack[torch.clamp(rows, 0, tri_pack.shape[0] - 1)]
            g = idx[li]
            hit, win, t, u, v = _leaf_scan(
                tp, [c[g][:, None] for c in o], [c[g][:, None] for c in d],
                tmin_f, cl[li], cnt[li], any_hit)
            hg = g[hit]
            closest[hg] = tmin_f if any_hit else t[hit]
            uu[hg] = u[hit]
            vv[hg] = v[hit]
            tri[hg] = rows[hit].gather(1, win[hit][:, None])[:, 0]

        tidx = nd * 16 + 2 * octant[idx]
        nxt = torch.where(enter & ~is_leaf, thr_flat[tidx],
                          thr_flat[tidx + 1]).to(torch.int64)
        if any_hit:
            nxt = torch.where(closest[idx] <= tmin_f, end, nxt)
        node[idx] = nxt
        idx = idx[nxt < end]

    t_out = torch.where(tri >= 0, closest, tmax_f)
    return (t_out.reshape(shape), uu.reshape(shape), vv.reshape(shape),
            tri.reshape(shape))


def wide_walk_plain(scene, ro: V3, rd: V3, t_min: float, t_max: float,
                    active: torch.Tensor, any_hit: bool = False):
    """The path kernel's walk (csrc/wide_walk.cuh) over the 8-ary table
    `wide_pack`, one ray at a time in numpy float32: the spec the kernel
    is held to, used by the tests.  Returns what `lane_traverse` returns,
    (t, u, v, tri), and must equal it ray for ray.

    A wide node's visit tests its 8 child boxes with the binary walk's
    slab arithmetic, giving each an interval (lo, hi) without the running
    closest t, and pushes the children it enters (nmin(hi, closest) > lo)
    in reverse visit order (the octant's rank word), so the first in the
    binary walk's order is popped first.  A pop re-tests the interval
    against the current closest, as the binary walk tests that box when
    it reaches it; an interior child is then visited, a leaf child's rows
    scanned in order with `<=`.  Under walk_counter it adds the wide
    nodes visited ("wide_visits") and its triangle tests ("wide_tests",
    equal to the binary walk's "tests")."""
    f32 = np.float32
    wide = scene.wide_pack.cpu().numpy()
    wint = wide.view(np.int32)
    tp = scene.tri_pack.cpu().numpy()
    o_all = np.stack([c.reshape(-1).cpu().numpy() for c in ro], 1).astype(f32)
    d_all = np.stack([c.reshape(-1).cpu().numpy() for c in rd], 1).astype(f32)
    act = active.reshape(-1).cpu().numpy()
    n = act.size
    t_out = np.full(n, f32(t_max), f32)
    u_out = np.zeros(n, f32)
    v_out = np.zeros(n, f32)
    tri_out = np.full(n, -1, np.int64)
    tmin, tmax = f32(t_min), f32(t_max)
    boxes = wide[:, :64].reshape(-1, 8, 8)
    lo_b, hi_b = boxes[:, :, 0:3], boxes[:, :, 3:6]
    refs = wint[:, :64].reshape(-1, 8, 8)[:, :, 6:8]
    ranks = (wint[:, 64:72, None] >> (3 * np.arange(8))) & 7   # (Nw, oct, slot)
    visits = tests = 0
    for i in np.nonzero(act)[0] if scene.n_tris > 0 else ():
        o, d = o_all[i], d_all[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = f32(1.0) / d
        neg = inv < 0
        octant = int(d[0] < 0) + 2 * int(d[1] < 0) + 4 * int(d[2] < 0)
        closest, hit = tmax, None
        stack, node = [], 0
        while node is not None:
            visits += 1
            with np.errstate(invalid="ignore", over="ignore"):
                t0 = (lo_b[node] - o) * inv                     # (8, 3)
                t1 = (hi_b[node] - o) * inv
            near = np.where(neg, t1, t0)
            far = np.where(neg, t0, t1)
            lo = np.maximum(np.maximum(np.maximum(tmin, near[:, 0]),
                                       near[:, 1]), near[:, 2])
            hi = np.minimum(np.minimum(far[:, 0], far[:, 1]), far[:, 2])
            entered = np.minimum(hi, closest) > lo
            for k in sorted(np.nonzero(entered)[0],
                            key=lambda k: -ranks[node, octant, k]):
                stack.append((lo[k], hi[k], int(refs[node, k, 0]),
                              int(refs[node, k, 1])))
            node = None
            while stack:
                lo_k, hi_k, ref, cnt = stack.pop()
                if not np.minimum(hi_k, closest) > lo_k:
                    continue
                if cnt == 0:
                    node = ref
                    break
                tests += cnt
                for r in range(ref, ref + cnt):
                    r = min(r, tp.shape[0] - 1)
                    got = _mt_row(tp[r], o, d, tmin, closest)
                    if got is not None:
                        closest = tmin if any_hit else got[0]
                        hit = (r, got[1], got[2])
                if any_hit and hit is not None:
                    stack.clear()
        if hit is not None:
            t_out[i], u_out[i], v_out[i], tri_out[i] = (closest, hit[1],
                                                        hit[2], hit[0])
    if _COUNTS is not None:
        _COUNTS["wide_visits"] = _COUNTS["wide_visits"] + visits
        _COUNTS["wide_tests"] = _COUNTS["wide_tests"] + tests
    shape, dev = ro.x.shape, ro.x.device
    return tuple(torch.from_numpy(a).reshape(shape).to(dev)
                 for a in (t_out, u_out, v_out, tri_out))


def _mt_row(row, o, d, t_min, closest):
    """Moller-Trumbore on one tri_pack row in _leaf_scan's arithmetic:
    (t, u, v) when it accepts (t_min <= t <= closest), else None."""
    e1x, e1y, e1z, e2x, e2y, e2z = row[3:9]
    pvx = d[1] * e2z - d[2] * e2y
    pvy = d[2] * e2x - d[0] * e2z
    pvz = d[0] * e2y - d[1] * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = abs(det) >= np.float32(1e-8)
    inv_det = np.float32(1.0) / (det if ok else np.float32(1.0))
    tvx, tvy, tvz = o[0] - row[0], o[1] - row[1], o[2] - row[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    ok = ok and u >= 0 and u <= 1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det
    ok = ok and v >= 0 and u + v <= 1
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return (t, u, v) if ok and t >= t_min and t <= closest else None


def hit_from_kernel(scene, ro: V3, rd: V3, t, u, v, tri, t_max) -> Hit:
    """Full hit record from a walk's (t, u, v, tri) with one row gather
    from tri_shade (normal, uvs, material, texture)."""
    hitmask = tri >= 0
    trc = torch.clamp(tri, 0, scene.tri_shade.shape[0] - 1).to(torch.int64)
    ts = scene.tri_shade[trc]
    nx, ny, nz = ts[..., 0], ts[..., 1], ts[..., 2]
    w = 1.0 - u - v
    tu = w * ts[..., 3] + u * ts[..., 5] + v * ts[..., 7]
    tv = w * ts[..., 4] + u * ts[..., 6] + v * ts[..., 8]
    mat = ts[..., 9].to(torch.int64)
    tex = ts[..., 10].to(torch.int64)
    front = (rd.x * nx + rd.y * ny + rd.z * nz) < 0.0
    sgn = torch.where(front, 1.0, -1.0).to(torch.float32)
    zero = torch.zeros_like(t)
    return Hit(
        hit=hitmask,
        t=torch.where(hitmask, t, torch.full_like(t, float(t_max))),
        nx=torch.where(hitmask, sgn * nx, zero),
        ny=torch.where(hitmask, sgn * ny, zero),
        nz=torch.where(hitmask, sgn * nz, zero),
        front=hitmask & front,
        mat=torch.where(hitmask, mat, 0),
        tex=torch.where(hitmask, tex, -1),
        tri=tri,
        u=torch.where(hitmask, u, zero),
        v=torch.where(hitmask, v, zero),
        tu=torch.where(hitmask, tu, zero),
        tv=torch.where(hitmask, tv, zero),
        medium=torch.full(t.shape, -1, dtype=torch.int64, device=t.device))


def smooth_normals(scene, rd: V3, hit: Hit) -> Hit:
    """On a smooth scene, the triangle hits' shading normal: the
    barycentric blend of the vertex normals in tri_aux, normalised, then
    face-flipped by its own `front`."""
    if not scene.has_smooth:
        return hit
    trc = torch.clamp(hit.tri, 0, scene.tri_aux.shape[0] - 1)
    ta = scene.tri_aux[trc]
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    nx = w * ta[..., 0] + u * ta[..., 3] + v * ta[..., 6]
    ny = w * ta[..., 1] + u * ta[..., 4] + v * ta[..., 7]
    nz = w * ta[..., 2] + u * ta[..., 5] + v * ta[..., 8]
    nlen = sqrt(nx * nx + ny * ny + nz * nz)
    ninv = torch.where(nlen > 0, 1.0 / torch.clamp_min(nlen, 1e-38),
                       torch.zeros_like(nlen))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    front = (rd.x * nx + rd.y * ny + rd.z * nz) < 0.0
    sgn = torch.where(front, 1.0, -1.0).to(torch.float32)
    m = hit.hit
    return hit._replace(nx=torch.where(m, sgn * nx, hit.nx),
                        ny=torch.where(m, sgn * ny, hit.ny),
                        nz=torch.where(m, sgn * nz, hit.nz),
                        front=torch.where(m, front, hit.front))


def _count(key: str, active, n: int) -> None:
    if _COUNTS is not None and n:
        _COUNTS[key] = _COUNTS[key] + active.sum() * n


def empty_hit(shape, t_max: float, device) -> Hit:
    """All-miss record (t = t_max) for scenes without triangles."""
    f0 = torch.zeros(shape, dtype=torch.float32, device=device)
    none = torch.full(shape, -1, dtype=torch.int64, device=device)
    return Hit(hit=torch.zeros(shape, dtype=torch.bool, device=device),
               t=torch.full(shape, float(t_max), dtype=torch.float32,
                            device=device),
               nx=f0, ny=f0, nz=f0,
               front=torch.zeros(shape, dtype=torch.bool, device=device),
               mat=torch.zeros(shape, dtype=torch.int64, device=device),
               tex=none, tri=none, u=f0, v=f0, tu=f0, tv=f0, medium=none)


def _update(hit: Hit, ok: torch.Tensor, **fields) -> Hit:
    """Lanes in `ok` take the given fields; hit |= ok."""
    new = {k: torch.where(ok, v, getattr(hit, k)) for k, v in fields.items()}
    return hit._replace(hit=hit.hit | ok, **new)


def sphere_pass(scene, ro: V3, rd: V3, t_min: float, hit: Hit, active,
                time=None) -> Hit:
    """Sequential sphere loop after the walk (later spheres win ties)."""
    if scene.n_spheres == 0:
        return hit
    _count("spheres", active, scene.n_spheres)
    dev = ro.x.device
    tmin = const(t_min, dev)
    with_time = time is not None and scene.has_moving
    closest = hit.t
    a = dot(rd, rd)
    zero = torch.zeros_like(a)
    for i in range(scene.n_spheres):
        c = scene.sph_center[i]
        cx, cy, cz = c[0], c[1], c[2]
        if with_time:
            c2 = scene.sph_center2[i]
            cx = cx + time * (c2[0] - cx)
            cy = cy + time * (c2[1] - cy)
            cz = cz + time * (c2[2] - cz)
        r = scene.sph_radius[i]
        oc = V3(ro.x - cx, ro.y - cy, ro.z - cz)
        half_b = dot(oc, rd)
        cq = dot(oc, oc) - r * r
        disc = half_b * half_b - a * cq
        has = disc >= 0.0
        sq = sqrt(torch.clamp_min(disc, 0.0))
        root1 = (-half_b - sq) / a
        root2 = (-half_b + sq) / a
        r1ok = (root1 >= tmin) & (root1 <= closest)
        root = torch.where(r1ok, root1, root2)
        ok = has & (root >= tmin) & (root <= closest) & active
        inv_r = 1.0 / torch.where(r != 0, r, torch.ones_like(r))
        nx = (ro.x + root * rd.x - cx) * inv_r
        ny = (ro.y + root * rd.y - cy) * inv_r
        nz = (ro.z + root * rd.z - cz) * inv_r
        front = (rd.x * nx + rd.y * ny + rd.z * nz) < 0.0
        sgn = torch.where(front, 1.0, -1.0).to(torch.float32)
        hit = _update(hit, ok, t=root, nx=sgn * nx, ny=sgn * ny,
                      nz=sgn * nz, front=front,
                      mat=scene.sph_mat[i].to(torch.int64).expand(ok.shape),
                      tex=torch.full_like(hit.tex, -1),
                      tri=torch.full_like(hit.tri, -1), u=zero, v=zero,
                      tu=zero, tv=zero, medium=torch.full_like(hit.medium,
                                                               -1))
        closest = torch.where(ok, root, closest)
    return hit


def quad_pass(scene, ro: V3, rd: V3, t_min: float, hit: Hit,
              active) -> Hit:
    """Sequential quad loop after the sphere pass (later quads win ties);
    alpha and beta land in u, v and tu, tv."""
    if scene.n_quads == 0:
        return hit
    _count("quads", active, scene.n_quads)
    tmin = const(t_min, ro.x.device)
    closest = hit.t
    for i in range(scene.n_quads):
        qn = scene.quad_n[i]
        denom = rd.x * qn[0] + rd.y * qn[1] + rd.z * qn[2]
        ok = torch.abs(denom) >= 1e-8
        t = (scene.quad_d[i] - (ro.x * qn[0] + ro.y * qn[1] + ro.z * qn[2])
             ) / torch.where(ok, denom, torch.ones_like(denom))
        ok = ok & (t >= tmin) & (t <= closest) & active
        q = scene.quad_q[i]
        px = ro.x + t * rd.x - q[0]
        py = ro.y + t * rd.y - q[1]
        pz = ro.z + t * rd.z - q[2]
        ue, ve, w = scene.quad_u[i], scene.quad_v[i], scene.quad_w[i]
        cx = py * ve[2] - pz * ve[1]
        cy = pz * ve[0] - px * ve[2]
        cz = px * ve[1] - py * ve[0]
        alpha = w[0] * cx + w[1] * cy + w[2] * cz
        cx = ue[1] * pz - ue[2] * py
        cy = ue[2] * px - ue[0] * pz
        cz = ue[0] * py - ue[1] * px
        beta = w[0] * cx + w[1] * cy + w[2] * cz
        ok = (ok & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
              & (beta <= 1.0))
        front = denom < 0.0
        sgn = torch.where(front, 1.0, -1.0).to(torch.float32)
        hit = _update(hit, ok, t=t, nx=sgn * qn[0], ny=sgn * qn[1],
                      nz=sgn * qn[2], front=front,
                      mat=scene.quad_mat[i].to(torch.int64).expand(ok.shape),
                      tex=torch.full_like(hit.tex, -1),
                      tri=torch.full_like(hit.tri, -1), u=alpha, v=beta,
                      tu=alpha, tv=beta,
                      medium=torch.full_like(hit.medium, -1))
        closest = torch.where(ok, t, closest)
    return hit


def boundary_interval(scene, m: int, ro: V3, rd: V3):
    """(has, t0, t1) of medium m's boundary along the rays, both roots
    of a sphere or the slab interval of a box, in an unbounded range."""
    c = scene.med_center[m]
    r = scene.med_radius[m]
    oc = V3(ro.x - c[0], ro.y - c[1], ro.z - c[2])
    a = dot(rd, rd)
    half_b = dot(oc, rd)
    cq = dot(oc, oc) - r * r
    disc = half_b * half_b - a * cq
    sq = sqrt(torch.clamp_min(disc, 0.0))
    s_has = disc > 0.0
    s_t0 = (-half_b - sq) / a
    s_t1 = (-half_b + sq) / a
    bmin, bmax = scene.med_min[m], scene.med_max[m]
    t0 = torch.full_like(ro.x, -3e38)
    t1 = torch.full_like(ro.x, 3e38)
    for axis, (o, d) in enumerate(zip(ro, rd)):
        inv = 1.0 / d
        ta = (bmin[axis] - o) * inv
        tb = (bmax[axis] - o) * inv
        t0 = torch.maximum(t0, torch.minimum(ta, tb))
        t1 = torch.minimum(t1, torch.maximum(ta, tb))
    b_has = t1 > t0
    is_sph = scene.med_kind[m] == 0
    return (torch.where(is_sph, s_has, b_has), torch.where(is_sph, s_t0, t0),
            torch.where(is_sph, s_t1, t1))


def media_pass(scene, ro: V3, rd: V3, t_min: float, hit: Hit, active,
               state):
    """Constant-medium scattering: one draw per medium on every active
    lane; the log is taken in float64 and rounded once."""
    if scene.n_media == 0:
        return hit, state
    _count("media", active, scene.n_media)
    rlen = sqrt(dot(rd, rd))
    rlen_safe = torch.clamp_min(rlen, 1e-30)
    for i in range(scene.n_media):
        has, t0, t1 = boundary_interval(scene, i, ro, rd)
        e0 = torch.clamp_min(t0, float(t_min))
        e1 = torch.minimum(t1, hit.t)
        inside = has & (e0 < e1) & active
        u, state = rngmod.draw(state, active)
        dist_inside = (e1 - e0) * rlen
        hit_dist = scene.med_neg_inv_density[i] * f64_op(
            torch.log, torch.clamp_min(u, 1e-30))
        ok = inside & (hit_dist <= dist_inside)
        one = torch.ones_like(e0)
        zero = torch.zeros_like(e0)
        hit = _update(hit, ok, t=e0 + hit_dist / rlen_safe, nx=one, ny=zero,
                      nz=zero, front=torch.ones_like(inside),
                      mat=torch.zeros_like(hit.mat),
                      tex=torch.full_like(hit.tex, -1),
                      tri=torch.full_like(hit.tri, -1), u=zero, v=zero,
                      tu=zero, tv=zero, medium=torch.full_like(hit.medium, i))
    return hit, state


def _primitives(scene, ro: V3, rd: V3, t_min: float, hit: Hit, active,
                state, time):
    """After the walk: smooth normals, spheres, quads, then media."""
    hit = smooth_normals(scene, rd, hit)
    hit = sphere_pass(scene, ro, rd, t_min, hit, active, time=time)
    hit = quad_pass(scene, ro, rd, t_min, hit, active)
    return media_pass(scene, ro, rd, t_min, hit, active, state)


def scene_hit(scene, ro: V3, rd: V3, t_min: float, t_max: float, active,
              state, any_hit: bool = False, time=None):
    """Triangles (the walk), then spheres, quads and media; returns
    (Hit, state).  `any_hit` ends the triangle walk at its first hit;
    the primitive and medium passes always run in full."""
    if scene.n_tris > 0:
        t, u, v, tri = lane_traverse(scene, ro, rd, t_min, t_max, active,
                                     any_hit=any_hit)
        hit = hit_from_kernel(scene, ro, rd, t, u, v, tri, t_max)
    else:
        hit = empty_hit(ro.x.shape, t_max, ro.x.device)
    return _primitives(scene, ro, rd, t_min, hit, active, state, time)


def scene_hit_flat(scene, ro: V3, rd: V3, t_min: float, t_max: float,
                   active, state, any_hit: bool = False, time=None):
    """scene_hit with the triangle walk through ops/traverse.traverse (the
    `dsrt_traverse` kernel on CUDA tensors; it returns the same
    (t, u, v, tri), so smooth normals are blended on its result), then
    the primitive and medium passes; returns (Hit, state)."""
    from dsrt_tpu_torch.ops.traverse import traverse
    if scene.n_tris > 0:
        t, u, v, tri = traverse(scene, ro, rd, active, t_min, t_max,
                                any_hit=any_hit)
        hit = hit_from_kernel(scene, ro, rd, t, u, v, tri, t_max)
    else:
        hit = empty_hit(ro.x.shape, t_max, ro.x.device)
    return _primitives(scene, ro, rd, t_min, hit, active, state, time)


def scene_hit_flat_sun(scene, ro: V3, rd: V3, t_min: float, t_max: float,
                       active, sun_ldir: V3, shadow_bias: float, sun):
    """Closest hit and the sun-shadow test in one traversal launch
    (`dsrt_traverse_sun` on CUDA tensors) for scenes of flat triangles
    only; returns (Hit, blocked), `blocked` valid on hit lanes.  `sun`:
    the caller's `traverse.sun_vector(sun_ldir, shadow_bias)`."""
    from dsrt_tpu_torch.ops.traverse import traverse_with_sun
    t, u, v, tri, blocked = traverse_with_sun(
        scene, ro, rd, active, t_min, t_max, sun_ldir, shadow_bias, sun)
    return hit_from_kernel(scene, ro, rd, t, u, v, tri, t_max), blocked
