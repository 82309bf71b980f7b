"""Plain scene intersection: the per-ray stackless BVH walk, the sphere
and constant-medium passes, and hit assembly.

Port of dsrt_tpu/ops/trace.py:465-590 (`lane_traverse`), :652-683
(`hit_from_kernel`), :258-319 (`sphere_pass`), :383-462
(`_boundary_interval`, `media_pass`) and :639-649 (`scene_hit`).  Every
ray walks the octant thread table on its own: octant o = (dx<0) +
2(dy<0) + 4(dz<0); an entered interior node continues at thr[node, 2o]
(the near child), anything else at thr[node, 2o+1] (the next node after
the subtree).  Leaves are scanned in
row order with `<=` acceptance against the running closest t, so ties go
to the later row — the walk order, and hence the accepted triangle, is
the reference's.  The CUDA kernels (csrc/walk.cuh) walk the same way.

Spheres are tested one after another after the walk, accepting
t <= closest, so a later sphere wins a tie; with a per-lane shutter time
a moving centre is c0 + t (c2 - c0).  Each medium then draws once on
every active lane of every query (shadow queries included) and scatters
where the free path -log(u) / density ends inside its boundary interval
and before the nearest surface.

This is the plain version: rays are vectorised, and each step works on
the rays still walking (compacted), so it runs on CPU or CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsrt_tpu_torch.ops import rng as rngmod
from dsrt_tpu_torch.ops.linalg import V3, dot, f64_op, sqrt


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
    dev = ro.x.device
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)
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


def scene_hit(scene, ro: V3, rd: V3, t_min: float, t_max: float, active,
              state, any_hit: bool = False, time=None):
    """Triangles (the walk), then spheres, then media; returns
    (Hit, state).  `any_hit` ends the triangle walk at its first hit;
    the sphere and medium passes always run in full."""
    if scene.n_tris > 0:
        t, u, v, tri = lane_traverse(scene, ro, rd, t_min, t_max, active,
                                     any_hit=any_hit)
        hit = hit_from_kernel(scene, ro, rd, t, u, v, tri, t_max)
    else:
        hit = empty_hit(ro.x.shape, t_max, ro.x.device)
    hit = sphere_pass(scene, ro, rd, t_min, hit, active, time=time)
    return media_pass(scene, ro, rd, t_min, hit, active, state)
