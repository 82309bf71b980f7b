"""Host-side BVH construction over triangle soups (a copy of
dsrt_tpu/models/bvh_build.py).

Two builders emitting the same flat, preorder node table consumed by the
packet traversal (ops/trace.py):

- `method="median"`: the reference's algorithm
  (src/gpu_scene_builder.cpp:343-459): recursive median split on the
  largest-extent centroid axis via nth_element, leaf <= 4 triangles,
  degenerate centroid bounds -> leaf, nodes appended preorder (root = 0),
  internal nodes flagged tri_count == 0.
- `method="sah"`: binned surface-area-heuristic splits (16 bins) — a
  higher-quality tree (fewer node visits per ray) with the same node
  schema.  Traversal results are identical for any valid tree, so this is
  a pure performance knob.
- `method="sbvh"`: SAH with binned SPATIAL splits (SBVH) — straddling
  triangles are referenced on both sides with clipped bounds, so
  `tri_indices` is a reference LIST (len >= N, may repeat a triangle),
  not a permutation.  Same traversal results (duplicate accepts are
  idempotent); fewer node visits on scenes with long thin diagonal
  triangles (truss/cylinder geometry).

A native C++ builder (csrc/bvh_builder.cpp) implements the same
algorithms; `build_bvh` dispatches to it when the shared library is
available (see dsrt_tpu_torch.native).

Node schema mirrors GPUBVHNode (inc/gpu_scene.h:77-85):
bbox_min/bbox_max f32[3], left/right child node indices, tri_offset/
tri_count range into the `tri_indices` permutation; tri_count > 0 <=> leaf.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

MAX_LEAF = 4
SAH_BINS = 16

# Degenerate-extent padding.  The reference stores exact triangle bounds, so
# an axis-aligned triangle produces a flat box and the slab test's
# `t_max <= t_min -> miss` (src/gpu_render.cu:312) makes it invisible — a
# latent bug in the CUDA renderer.  We pad near-zero extents like the
# Shirley-series `aabb::pad`, a deliberate correctness deviation.
FLAT_EPS = np.float32(1e-4)


def _pad_flat(mn: np.ndarray, mx: np.ndarray):
    """Expand axes with near-zero extent by FLAT_EPS/2 on each side."""
    flat = (mx - mn) < FLAT_EPS
    return (np.where(flat, mn - FLAT_EPS * 0.5, mn).astype(np.float32),
            np.where(flat, mx + FLAT_EPS * 0.5, mx).astype(np.float32))


@dataclasses.dataclass
class BVH:
    bbox_min: np.ndarray   # (B,3) f32
    bbox_max: np.ndarray   # (B,3) f32
    left: np.ndarray       # (B,) i32
    right: np.ndarray      # (B,) i32
    tri_offset: np.ndarray  # (B,) i32
    tri_count: np.ndarray  # (B,) i32
    tri_indices: np.ndarray  # (N,) i32

    @property
    def num_nodes(self) -> int:
        return len(self.left)

    @property
    def max_leaf_size(self) -> int:
        return int(self.tri_count.max()) if len(self.tri_count) else 0


def _tri_bounds_centroids(v0, v1, v2):
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = ((v0 + v1 + v2) / 3.0).astype(np.float32)
    return lo, hi, cent


def build_bvh(v0, v1, v2, method: str = "median", prefer_native: bool = True,
              sbvh_alpha: float = 1e-5, sbvh_ref_budget: float = 2.0) -> BVH:
    """Build a BVH over triangles given as (N,3) vertex arrays.

    `sbvh_alpha` / `sbvh_ref_budget` tune SBVH spatial splitting
    (overlap gate as a fraction of root SA; reference cap as a
    multiple of N) — ignored for median/sah."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    n = len(v0)
    if n == 0:
        # single dead node so traversal arrays are never empty
        z = np.zeros((1, 3), np.float32)
        return BVH(z, z, -np.ones(1, np.int32), -np.ones(1, np.int32),
                   np.zeros(1, np.int32), np.zeros(1, np.int32),
                   np.zeros(0, np.int32))
    if prefer_native and method in ("median", "sah", "sbvh"):
        try:
            from dsrt_tpu_torch import native
            out = native.build_bvh(v0, v1, v2, method,
                                   alpha=sbvh_alpha,
                                   ref_budget=sbvh_ref_budget)
            if out is not None:
                return out
        except ImportError:
            pass
    if method == "median":
        return _build_median(v0, v1, v2)
    if method == "sah":
        return _build_sah(v0, v1, v2)
    if method == "sbvh":
        return _build_sbvh(v0, v1, v2, ref_budget=sbvh_ref_budget,
                           alpha=sbvh_alpha)
    raise ValueError(f"unknown BVH method '{method}'")


def _build_median(v0, v1, v2) -> BVH:
    lo, hi, cent = _tri_bounds_centroids(v0, v1, v2)
    n = len(cent)
    indices = np.arange(n, dtype=np.int32)

    bbox_min, bbox_max = [], []
    left, right, tri_offset, tri_count = [], [], [], []

    sys.setrecursionlimit(max(10000, 64 * int(np.log2(n + 2)) + 10000))

    def recurse(start: int, end: int) -> int:
        node = len(left)
        idx = indices[start:end]
        mn, mx = _pad_flat(lo[idx].min(axis=0), hi[idx].max(axis=0))
        bbox_min.append(mn)
        bbox_max.append(mx)
        left.append(-1)
        right.append(-1)
        tri_offset.append(start)
        tri_count.append(end - start)

        count = end - start
        if count <= MAX_LEAF:
            return node

        c = cent[idx]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        diag = cmax - cmin
        # largest-extent axis with the reference's tie-breaking
        # (builder.cpp:404-406): y wins over x if strictly greater and >= z;
        # z wins over x if strictly greater and >= y; else x.
        axis = 0
        if diag[1] > diag[0] and diag[1] >= diag[2]:
            axis = 1
        elif diag[2] > diag[0] and diag[2] >= diag[1]:
            axis = 2
        if diag[axis] == 0.0:  # degenerate -> keep as leaf
            return node

        mid = (start + end) // 2
        k = mid - start
        part = np.argpartition(c[:, axis], k, kind="introselect")
        indices[start:end] = idx[part]

        tri_offset[node] = 0
        tri_count[node] = 0
        left[node] = recurse(start, mid)
        right[node] = recurse(mid, end)
        return node

    recurse(0, n)
    return BVH(np.asarray(bbox_min, np.float32), np.asarray(bbox_max, np.float32),
               np.asarray(left, np.int32), np.asarray(right, np.int32),
               np.asarray(tri_offset, np.int32), np.asarray(tri_count, np.int32),
               indices)


def _build_sah(v0, v1, v2, max_leaf: int = MAX_LEAF) -> BVH:
    lo, hi, cent = _tri_bounds_centroids(v0, v1, v2)
    n = len(cent)
    indices = np.arange(n, dtype=np.int32)

    bbox_min, bbox_max = [], []
    left, right, tri_offset, tri_count = [], [], [], []

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    def recurse(start: int, end: int) -> int:
        node = len(left)
        idx = indices[start:end]
        nb_min = lo[idx].min(axis=0)
        nb_max = hi[idx].max(axis=0)
        pmn, pmx = _pad_flat(nb_min, nb_max)
        bbox_min.append(pmn)
        bbox_max.append(pmx)
        left.append(-1)
        right.append(-1)
        tri_offset.append(start)
        tri_count.append(end - start)

        count = end - start
        if count <= max_leaf:
            return node

        c = cent[idx]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        diag = cmax - cmin
        axis = int(np.argmax(diag))
        if diag[axis] <= 0.0:
            return node

        # binned SAH along the widest centroid axis
        rel = (c[:, axis] - cmin[axis]) / diag[axis]
        bins = np.minimum((rel * SAH_BINS).astype(np.int32), SAH_BINS - 1)
        bin_lo = np.full((SAH_BINS, 3), np.inf, np.float32)
        bin_hi = np.full((SAH_BINS, 3), -np.inf, np.float32)
        bin_n = np.zeros(SAH_BINS, np.int64)
        for b in range(SAH_BINS):
            m = bins == b
            if m.any():
                bin_lo[b] = lo[idx[m]].min(axis=0)
                bin_hi[b] = hi[idx[m]].max(axis=0)
                bin_n[b] = int(m.sum())
        # prefix/suffix sweeps
        pre_lo = np.minimum.accumulate(bin_lo, axis=0)
        pre_hi = np.maximum.accumulate(bin_hi, axis=0)
        pre_n = np.cumsum(bin_n)
        suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        suf_n = np.cumsum(bin_n[::-1])[::-1]

        best_cost, best_split = np.inf, -1
        for s in range(SAH_BINS - 1):
            nl, nr = pre_n[s], suf_n[s + 1]
            if nl == 0 or nr == 0:
                continue
            cost = (surface(pre_lo[s], pre_hi[s]) * nl
                    + surface(suf_lo[s + 1], suf_hi[s + 1]) * nr)
            if cost < best_cost:
                best_cost, best_split = cost, s

        leaf_cost = surface(nb_min, nb_max) * count
        if best_split < 0 or (count <= 2 * max_leaf and best_cost >= leaf_cost):
            # fall back to a median split to guarantee progress
            k = count // 2
            part = np.argpartition(c[:, axis], k, kind="introselect")
            indices[start:end] = idx[part]
            mid = start + k
        else:
            go_left = bins <= best_split
            indices[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = start + int(go_left.sum())

        tri_offset[node] = 0
        tri_count[node] = 0
        left[node] = recurse(start, mid)
        right[node] = recurse(mid, end)
        return node

    sys.setrecursionlimit(max(10000, 64 * int(np.log2(n + 2)) + 10000))
    recurse(0, n)
    return BVH(np.asarray(bbox_min, np.float32), np.asarray(bbox_max, np.float32),
               np.asarray(left, np.int32), np.asarray(right, np.int32),
               np.asarray(tri_offset, np.int32), np.asarray(tri_count, np.int32),
               indices)


def _clip_tri_aabb(p0, p1, p2, axis: int, x0: float, x1: float):
    """AABBs of triangles clipped to the axis slab [x0, x1], vectorized
    over (K,3) vertex arrays.  The clipped polygon's AABB is the AABB of
    (a) vertices inside the slab and (b) edge/plane intersection points —
    no polygon needs to be built (chopped-binning trick, Stich et al.
    2009 §4.2).  Returns (lo, hi) with +/-inf where a triangle misses
    the slab entirely."""
    P = np.stack([p0, p1, p2], axis=1)                 # (K,3verts,3)
    x = P[:, :, axis]
    lo = np.full(P.shape, np.inf, np.float32)
    hi = np.full(P.shape, -np.inf, np.float32)
    inside = (x >= x0) & (x <= x1)                     # (K,3)
    lo = np.where(inside[..., None], P, lo)
    hi = np.where(inside[..., None], P, hi)
    pts_lo, pts_hi = [lo], [hi]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for e in range(3):
            a, b = P[:, e], P[:, (e + 1) % 3]
            xa, xb = a[:, axis], b[:, axis]
            d = xb - xa
            for xp in (x0, x1):
                if not np.isfinite(xp):
                    continue           # half-open slab: no plane there
                cross = ((xa - xp) * (xb - xp) < 0.0)  # strict crossing
                t = np.where(d != 0.0,
                             (xp - xa) / np.where(d == 0, 1, d), 0.0)
                q = a + t[:, None] * (b - a)
                q[:, axis] = xp                        # exact on the plane
                big = np.where(cross[:, None], q, np.inf)
                pts_lo.append(big[:, None])
                pts_hi.append(np.where(cross[:, None], q, -np.inf)[:, None])
    allp_lo = np.concatenate(pts_lo, axis=1)
    allp_hi = np.concatenate(pts_hi, axis=1)
    return (allp_lo.min(axis=1).astype(np.float32),
            allp_hi.max(axis=1).astype(np.float32))


def _build_sbvh(v0, v1, v2, max_leaf: int = MAX_LEAF,
                ref_budget: float = 2.0, alpha: float = 1e-5) -> BVH:
    """Spatial-split BVH (SBVH, Stich/Friedrich/Dammertz 2009): binned
    object SAH (all 3 axes) per node, PLUS a binned spatial split when
    the object split's children overlap significantly — triangles that
    straddle the chosen plane are then REFERENCED in both children with
    their bounds clipped to each side.  Long thin diagonal triangles
    (truss/cylinder geometry) stop inflating their nodes' boxes, which
    cuts node visits for the traversal kernels; the tri set per closest
    hit is unchanged so images are bit-identical.

    Output schema matches the other builders except `tri_indices` is a
    REFERENCE list (may repeat a triangle, len >= N) and a leaf's box
    bounds only its refs' CLIPPED extents.  Closest-hit traversal stays
    exact: every point of a triangle lies in some node that references
    it, and duplicate accepts are idempotent (same t/u/v/attributes).

    `ref_budget` caps total references at budget*N (spatial splitting
    stops when exhausted); `alpha` is the overlap-area gate relative to
    the root surface below which only object splits are tried."""
    lo_t, hi_t, _ = _tri_bounds_centroids(v0, v1, v2)
    n = len(v0)
    # reference soup: tri id + clipped bounds (start = full tri bounds)
    ref_tri = np.arange(n, dtype=np.int32)
    ref_lo = lo_t.copy()
    ref_hi = hi_t.copy()
    max_refs = int(ref_budget * n)

    bbox_min, bbox_max = [], []
    left, right, tri_offset, tri_count = [], [], [], []
    leaf_refs: list[np.ndarray] = []   # tri ids per leaf, in emit order

    root_sa = None

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))

    def recurse(ids: np.ndarray, depth: int) -> int:
        nonlocal root_sa
        node = len(left)
        rlo, rhi = ref_lo[ids], ref_hi[ids]
        nb_min = rlo.min(axis=0)
        nb_max = rhi.max(axis=0)
        pmn, pmx = _pad_flat(nb_min, nb_max)
        bbox_min.append(pmn)
        bbox_max.append(pmx)
        left.append(-1)
        right.append(-1)
        tri_offset.append(-1)          # filled at emit time
        tri_count.append(len(ids))
        if root_sa is None:
            root_sa = max(surface(nb_min, nb_max), 1e-30)

        count = len(ids)
        if count <= max_leaf or depth > 62:
            tri_count[node] = count
            leaf_refs.append((node, ids))
            return node

        cent = 0.5 * (rlo + rhi)
        # ---- best binned OBJECT split over all 3 axes ------------------
        best = None                     # (cost, axis, go_left mask)
        cmin, cmax = cent.min(axis=0), cent.max(axis=0)
        for axis in range(3):
            ext = cmax[axis] - cmin[axis]
            if ext <= 0.0:
                continue
            rel = (cent[:, axis] - cmin[axis]) / ext
            bins = np.minimum((rel * SAH_BINS).astype(np.int32),
                              SAH_BINS - 1)
            bl = np.full((SAH_BINS, 3), np.inf, np.float32)
            bh = np.full((SAH_BINS, 3), -np.inf, np.float32)
            bn = np.zeros(SAH_BINS, np.int64)
            for b in range(SAH_BINS):
                m = bins == b
                if m.any():
                    bl[b] = rlo[m].min(axis=0)
                    bh[b] = rhi[m].max(axis=0)
                    bn[b] = int(m.sum())
            pre_lo = np.minimum.accumulate(bl, 0)
            pre_hi = np.maximum.accumulate(bh, 0)
            pre_n = np.cumsum(bn)
            suf_lo = np.minimum.accumulate(bl[::-1], 0)[::-1]
            suf_hi = np.maximum.accumulate(bh[::-1], 0)[::-1]
            suf_n = np.cumsum(bn[::-1])[::-1]
            for s in range(SAH_BINS - 1):
                nl, nr = pre_n[s], suf_n[s + 1]
                if nl == 0 or nr == 0:
                    continue
                d1 = np.maximum(pre_hi[s] - pre_lo[s], 0.0)
                d2 = np.maximum(suf_hi[s + 1] - suf_lo[s + 1], 0.0)
                cost = (2.0 * (d1[0] * d1[1] + d1[1] * d1[2]
                               + d1[2] * d1[0]) * nl
                        + 2.0 * (d2[0] * d2[1] + d2[1] * d2[2]
                                 + d2[2] * d2[0]) * nr)
                if best is None or cost < best[0]:
                    ov_lo = np.maximum(pre_lo[s], suf_lo[s + 1])
                    ov_hi = np.minimum(pre_hi[s], suf_hi[s + 1])
                    best = (cost, axis, bins <= s, ov_lo, ov_hi)

        # ---- binned SPATIAL split when object children overlap ---------
        spatial = None   # (cost, axis, plane)
        if best is not None and len(ref_tri) < max_refs:
            ov = np.maximum(best[4] - best[3], 0.0)
            ov_sa = 2.0 * (ov[0] * ov[1] + ov[1] * ov[2] + ov[2] * ov[0])
            if ov_sa / root_sa > alpha:
                t0a, t1a, t2a = (v0[ref_tri[ids]], v1[ref_tri[ids]],
                                 v2[ref_tri[ids]])
                for axis in range(3):
                    ext = float(nb_max[axis] - nb_min[axis])
                    if ext <= 0.0:
                        continue
                    w = ext / SAH_BINS
                    b0 = np.clip(((rlo[:, axis] - nb_min[axis]) / w)
                                 .astype(np.int32), 0, SAH_BINS - 1)
                    b1 = np.clip(((rhi[:, axis] - nb_min[axis]) / w)
                                 .astype(np.int32), 0, SAH_BINS - 1)
                    bl = np.full((SAH_BINS, 3), np.inf, np.float32)
                    bh = np.full((SAH_BINS, 3), -np.inf, np.float32)
                    entry = np.zeros(SAH_BINS, np.int64)
                    exit_ = np.zeros(SAH_BINS, np.int64)
                    np.add.at(entry, b0, 1)
                    np.add.at(exit_, b1, 1)
                    for b in range(SAH_BINS):
                        m = (b0 <= b) & (b1 >= b)
                        if not m.any():
                            continue
                        clo, chi = _clip_tri_aabb(
                            t0a[m], t1a[m], t2a[m], axis,
                            nb_min[axis] + b * w, nb_min[axis] + (b + 1) * w)
                        # clip against the ref's own (already-split) box
                        clo = np.maximum(clo, rlo[m])
                        chi = np.minimum(chi, rhi[m])
                        ok = (chi >= clo).all(axis=1)
                        if ok.any():
                            bl[b] = np.minimum(bl[b], clo[ok].min(axis=0))
                            bh[b] = np.maximum(bh[b], chi[ok].max(axis=0))
                    pre_lo = np.minimum.accumulate(bl, 0)
                    pre_hi = np.maximum.accumulate(bh, 0)
                    pre_n = np.cumsum(entry)
                    suf_lo = np.minimum.accumulate(bl[::-1], 0)[::-1]
                    suf_hi = np.maximum.accumulate(bh[::-1], 0)[::-1]
                    suf_n = np.cumsum(exit_[::-1])[::-1]
                    for s in range(SAH_BINS - 1):
                        nl, nr = pre_n[s], suf_n[s + 1]
                        if nl == 0 or nr == 0:
                            continue
                        d1 = np.maximum(pre_hi[s] - pre_lo[s], 0.0)
                        d2 = np.maximum(suf_hi[s + 1] - suf_lo[s + 1], 0.0)
                        cost = (2.0 * (d1[0] * d1[1] + d1[1] * d1[2]
                                       + d1[2] * d1[0]) * nl
                                + 2.0 * (d2[0] * d2[1] + d2[1] * d2[2]
                                         + d2[2] * d2[0]) * nr)
                        if cost < best[0] and (spatial is None
                                               or cost < spatial[0]):
                            spatial = (cost, axis,
                                       nb_min[axis] + (s + 1) * w)

        if best is None and spatial is None:
            tri_count[node] = count
            leaf_refs.append((node, ids))
            return node

        if spatial is not None:
            _, axis, plane = spatial
            l_only = ref_hi[ids][:, axis] <= plane
            r_only = ref_lo[ids][:, axis] >= plane
            straddle = ~(l_only | r_only)
            sid = ids[straddle]
            if len(sid) and len(ref_tri) + len(sid) <= max_refs:
                tri = ref_tri[sid]
                clo_l, chi_l = _clip_tri_aabb(v0[tri], v1[tri], v2[tri],
                                              axis, -np.inf, plane)
                clo_r, chi_r = _clip_tri_aabb(v0[tri], v1[tri], v2[tri],
                                              axis, plane, np.inf)
                clo_l = np.maximum(clo_l, ref_lo[sid])
                chi_l = np.minimum(chi_l, ref_hi[sid])
                clo_r = np.maximum(clo_r, ref_lo[sid])
                chi_r = np.minimum(chi_r, ref_hi[sid])
                # a ref's box can straddle while its clipped TRIANGLE is
                # empty on one side — those go one-sided (box tightened)
                ok_l = (chi_l >= clo_l).all(axis=1)
                ok_r = (chi_r >= clo_r).all(axis=1)
                both = ok_l & ok_r
                ref_lo[sid[ok_l]] = clo_l[ok_l]
                ref_hi[sid[ok_l]] = chi_l[ok_l]
                ref_lo[sid[ok_r & ~ok_l]] = clo_r[ok_r & ~ok_l]
                ref_hi[sid[ok_r & ~ok_l]] = chi_r[ok_r & ~ok_l]
                # refs valid on BOTH sides: left reuses the row (already
                # holds the left clip), right gets a fresh row
                new_ids = np.arange(len(ref_tri),
                                    len(ref_tri) + int(both.sum()),
                                    dtype=np.int64)
                _grow(tri[both], clo_r[both], chi_r[both])
                # never drop a ref: a numerically-empty clip on BOTH
                # sides keeps its original box and goes left
                left_ids = np.concatenate(
                    [ids[l_only], sid[ok_l], sid[~ok_l & ~ok_r]])
                right_ids = np.concatenate(
                    [ids[r_only], sid[ok_r & ~ok_l], new_ids])
                # degenerate guard: a clip can empty one side numerically
                if len(left_ids) and len(right_ids):
                    tri_offset[node] = 0
                    tri_count[node] = 0
                    left[node] = recurse(left_ids, depth + 1)
                    right[node] = recurse(right_ids, depth + 1)
                    return node
            # fall through to the object split on budget/degeneracy

        _, axis, go_left, _, _ = best
        left_ids, right_ids = ids[go_left], ids[~go_left]
        if len(left_ids) == 0 or len(right_ids) == 0:
            k = count // 2
            part = np.argpartition(cent[:, axis], k)
            left_ids, right_ids = ids[part[:k]], ids[part[k:]]
        tri_offset[node] = 0
        tri_count[node] = 0
        left[node] = recurse(left_ids, depth + 1)
        right[node] = recurse(right_ids, depth + 1)
        return node

    def _grow(tri, clo, chi):
        nonlocal ref_tri, ref_lo, ref_hi
        ref_tri = np.concatenate([ref_tri, tri])
        ref_lo = np.concatenate([ref_lo, clo])
        ref_hi = np.concatenate([ref_hi, chi])

    sys.setrecursionlimit(200000)
    recurse(np.arange(n, dtype=np.int64), 1)

    # emit tri_indices in leaf order (preorder emit order of leaves)
    out = np.empty(sum(len(ids) for _, ids in leaf_refs), np.int32)
    cursor = 0
    for node, ids in leaf_refs:
        tri_offset[node] = cursor
        out[cursor:cursor + len(ids)] = ref_tri[ids]
        cursor += len(ids)
    return BVH(np.asarray(bbox_min, np.float32),
               np.asarray(bbox_max, np.float32),
               np.asarray(left, np.int32), np.asarray(right, np.int32),
               np.asarray(tri_offset, np.int32),
               np.asarray(tri_count, np.int32), out)


@dataclasses.dataclass
class WideBVH:
    """8-ary collapse of a binary BVH for the fused Pallas kernel.

    `table` is f32[(arity*n_wide), 16]: wide node j's child records occupy
    sublane rows [arity*j, arity*(j+1)); child record fields are
    [minx,miny,minz,maxx,maxy,maxz, ptr, cnt, base, 0...] where

    - cnt > 0: leaf child covering tri rows [ptr, ptr+cnt) of the packed
      (leaf-ordered) triangle table;
    - cnt == 0 with a valid box: interior child; its wide node index is
      `ptr`.  All interior children of one node have CONSECUTIVE wide
      indices, and `base` (stored on child record 0 only) is the first —
      so the traversal kernel can compute push targets as base + rank
      from the packed hit bits alone, no per-child pointer loads;
    - empty slot: inverted box (min=+BIG, max=-BIG, never hit by the slab
      test), cnt == 0, ptr == 0.

    The per-child order preserves the binary tree's left-to-right
    (preorder) order.  `collapse_wide` additionally RE-GROUPS the
    triangle order so each wide node's leaf children cover one contiguous
    block (`src` maps new tri rows to old; the binary BVH's leaf offsets
    are rewritten in place) — so the kernel can scan all entered leaf
    children of a visit as ONE [min ptr, max end) loop whose only extras
    are this node's non-entered (small) leaf siblings, which the slab
    test proves cannot accept a hit.
    """
    table: np.ndarray          # (arity*n_wide, 16) f32
    n_wide: int
    arity: int
    max_leaf: int              # max tris in one wide leaf child
    depth: int                 # max wide-tree depth (stack bound)
    src: np.ndarray            # (N,) new-row -> old-row tri permutation

    @property
    def num_nodes(self) -> int:
        return self.n_wide


# Empty-slot box sentinel.  The kernel's slab test takes min/max of the
# two per-axis plane distances, so it is SIGN-INSENSITIVE: an "inverted"
# box (min > max) behaves like the normal box with swapped corners and
# would hit everything.  A zero-width box (min == max) can never pass the
# strict `hi > lo` test (lo >= t*_x and hi <= t*_x), so empty slots use
# min = max = _WIDE_BIG, which is also far outside every real scene.
_WIDE_BIG = np.float32(1e30)


def collapse_wide(bvh: BVH, arity: int = 8,
                  wide_max_leaf: int = 8) -> WideBVH:
    """Collapse a binary preorder BVH into a WideBVH.

    A wide node's children are found by repeatedly expanding (replacing
    with its two binary children, in place) the candidate child with the
    largest subtree triangle count, until `arity` slots are used or every
    child is a leaf.  A binary subtree whose whole tri range is at most
    `wide_max_leaf` becomes a single leaf child spanning that contiguous
    range — a pure box-test-count knob with identical intersection
    semantics.

    MUTATES `bvh.tri_offset`: triangles are re-grouped by wide node (see
    WideBVH.src) and the binary leaves' offsets are rewritten to match.
    Callers must permute their triangle arrays by `src`.
    """
    b = bvh.num_nodes
    is_int = (bvh.tri_count == 0) & (bvh.left >= 0)
    # subtree tri ranges (builder zeroes offset/count on interior nodes);
    # children follow parents in preorder, so a reverse loop suffices
    s = bvh.tri_offset.astype(np.int64).copy()
    e = s + bvh.tri_count.astype(np.int64)
    for i in range(b - 1, -1, -1):
        if is_int[i]:
            s[i] = s[bvh.left[i]]
            e[i] = e[bvh.right[i]]

    def children_of(root: int):
        ch = [root]
        while len(ch) < arity:
            # expand the largest still-interior child
            best, best_n = -1, -1
            for k, c in enumerate(ch):
                if is_int[c] and (e[c] - s[c]) > wide_max_leaf:
                    n = e[c] - s[c]
                    if n > best_n:
                        best, best_n = k, n
            if best < 0:
                break
            c = ch[best]
            ch[best:best + 1] = [bvh.left[c], bvh.right[c]]
        return ch

    rows = []                 # list of (arity,16) blocks
    # worklist of (wide_index, binary_node, depth); interior children of
    # one node are allocated consecutively at expansion time
    next_free = 1
    work = [(0, 0, 1)]
    max_depth = 1
    while work:
        j, bnode, d = work.pop()
        max_depth = max(max_depth, d)
        ch = children_of(bnode)
        blk = np.zeros((arity, 16), np.float32)
        blk[:, 0:3] = _WIDE_BIG
        blk[:, 3:6] = _WIDE_BIG   # zero-width => guaranteed miss
        base = next_free
        kI = 0
        intmask = 0
        for k, c in enumerate(ch):
            if e[c] - s[c] == 0 and not is_int[c]:
                continue      # dead node (empty scene) -> empty slot
            blk[k, 0:3] = bvh.bbox_min[c]
            blk[k, 3:6] = bvh.bbox_max[c]
            if is_int[c] and (e[c] - s[c]) > wide_max_leaf:
                blk[k, 6] = float(base + kI)
                blk[k, 7] = 0.0
                work.append((base + kI, c, d + 1))
                kI += 1
                intmask |= 1 << k
            else:
                blk[k, 6] = float(s[c])
                blk[k, 7] = float(e[c] - s[c])
        next_free += kI
        # base and interior-slot bitmask packed into ONE int32 stored
        # as its raw BIT PATTERN in the f32 lane (the kernel extracts
        # it with a bitcast, never float arithmetic, so all 32 bits
        # survive — f32-exact packing capped the table at 65536 wide
        # nodes, ~800k tris; the bit pattern caps at 2^23 nodes).
        # The kernel derives each entered interior child's index as
        # base + popcount(intmask below its slot); single field so the
        # lane-packed layout needs one scalar extraction per visit.
        blk[0, 8] = np.array([base * 256 + intmask],
                             np.int32).view(np.float32)[0]
        # prank: 3-bit packed rank-among-interior-slots per slot (the
        # ordered push loop needs rank by slot id without popcounts)
        prank = 0
        rk = 0
        int_slots, non_int = [], []
        for c in range(arity):
            if (intmask >> c) & 1:
                prank |= rk << (3 * c)
                rk += 1
                int_slots.append(c)
            else:
                non_int.append(c)
        blk[0, 9] = float(prank)
        # per-octant far-to-near permutation of the interior slots
        # (3-bit slot ids; ray-direction octant o has sign bit a set when
        # component a is negative, so the representative direction is
        # s_a = 1 - 2*((o >> a) & 1)); pads with a non-interior slot
        # (never entered as interior) when fewer than 8 interior children
        centers = 0.5 * (blk[:, 0:3] + blk[:, 3:6])
        pad_slot = non_int[0] if non_int else 0
        for o in range(arity):
            sv = np.array([1.0 - 2.0 * ((o >> a) & 1) for a in range(3)],
                          np.float32)
            order = sorted(int_slots,
                           key=lambda c: -float(centers[c] @ sv))
            perm = 0
            for jj in range(arity):
                c = order[jj] if jj < len(order) else pad_slot
                perm |= c << (3 * jj)
            blk[o, 10] = float(perm)
        rows.append((j, blk))

    n_wide = next_free
    table = np.zeros((arity * n_wide, 16), np.float32)
    for j, blk in rows:
        table[arity * j:arity * (j + 1)] = blk

    # ---- re-group triangles so each wide node's leaf children form one
    # contiguous block; rewrite wide ptrs and binary leaf offsets --------
    n = len(bvh.tri_indices)
    src = np.empty(max(n, 1), np.int64)
    new_of_old = np.empty(max(n, 1), np.int64)
    cursor = 0
    for j in range(n_wide):
        for c in range(arity):
            r = arity * j + c
            cnt = int(table[r, 7])
            if cnt <= 0:
                continue
            old = int(table[r, 6])
            src[cursor:cursor + cnt] = np.arange(old, old + cnt)
            new_of_old[old:old + cnt] = np.arange(cursor, cursor + cnt)
            table[r, 6] = float(cursor)
            cursor += cnt
    assert cursor == n, (cursor, n)
    if n:
        # binary leaves lie wholly inside one moved block -> shift offsets
        leaf = bvh.tri_count > 0
        bvh.tri_offset[leaf] = new_of_old[
            bvh.tri_offset[leaf].astype(np.int64)].astype(np.int32)
    else:
        src = np.zeros(0, np.int64)
    wml = int(max((blk[:, 7].max() for _, blk in rows), default=0))
    assert n_wide < (1 << 23), "base*256+intmask must fit int32"
    return WideBVH(table=table, n_wide=n_wide, arity=arity,
                   max_leaf=wml, depth=max_depth, src=src.astype(np.int32))


def lane_pack_wide(table: np.ndarray, arity: int = 8) -> np.ndarray:
    """Lane-pack the (arity*Nw, 16) wide table: 8 nodes per (8,128) VMEM
    tile — out[8g + r, 16j + f] = node (8g + j)'s child record r, field
    f.  True 512 B/node (the sublane-per-record layout wastes 8x on lane
    padding); the kernel extracts a node's (8,16) block with one dynamic
    lane roll (pltpu.roll) + static slice.  Padding nodes are zero
    (zero-width boxes, never hit; never popped either)."""
    n_wide = table.shape[0] // arity
    g = (n_wide + 7) // 8
    padded = np.zeros((g * 8 * arity, 16), table.dtype)
    padded[:table.shape[0]] = table
    # (g, j, r, f) -> (g, r, j, f)
    arr = padded.reshape(g, 8, arity, 16).transpose(0, 2, 1, 3)
    return arr.reshape(g * arity, 128)


def validate_wide(wide: WideBVH, bvh: BVH) -> None:
    """Assert the wide tree covers exactly the binary tree's tri set,
    with consecutive interior-child indices and per-node-contiguous leaf
    blocks (the kernel's union-range contract)."""
    A = wide.arity
    covered = []

    def walk(j):
        blk = wide.table[A * j:A * (j + 1)]
        # blk[0,8] holds base*256+intmask as an int32 BIT PATTERN in the
        # f32 lane (see collapse_wide) — extract by bitcast, not value
        base = int(np.asarray(blk[0, 8], np.float32)
                   .view(np.int32)) // 256
        rank = 0
        node_leaf = []
        for c in range(A):
            if blk[c, 0] >= _WIDE_BIG:      # empty slot
                continue
            cnt = int(blk[c, 7])
            ptr = int(blk[c, 6])
            if cnt > 0:
                node_leaf.append((ptr, ptr + cnt))
                covered.append((ptr, ptr + cnt))
            else:
                assert ptr == base + rank, "interior children not packed"
                rank += 1
                walk(ptr)
        for (a0, b0), (a1, b1) in zip(node_leaf, node_leaf[1:]):
            assert b0 == a1, "node leaf children must be one block"

    walk(0)
    covered.sort()
    total = sum(b - a for a, b in covered)
    assert total == len(bvh.tri_indices), (total, len(bvh.tri_indices))
    for (a0, b0), (a1, b1) in zip(covered, covered[1:]):
        assert b0 == a1, "leaf ranges must tile [0, n)"
    assert np.array_equal(np.sort(wide.src), np.arange(len(wide.src)))


def validate_bvh(bvh: BVH, lo: np.ndarray, hi: np.ndarray) -> None:
    """Assert structural invariants (used by tests): preorder children,
    bbox containment, exact leaf partition of tri indices."""
    n_nodes = bvh.num_nodes
    seen = np.zeros(len(bvh.tri_indices), bool)
    for i in range(n_nodes):
        if bvh.tri_count[i] > 0:
            s, c = bvh.tri_offset[i], bvh.tri_count[i]
            tris = bvh.tri_indices[s:s + c]
            assert not seen[tris].any(), "leaf ranges overlap"
            seen[tris] = True
            assert (lo[tris] >= bvh.bbox_min[i] - 1e-4).all()
            assert (hi[tris] <= bvh.bbox_max[i] + 1e-4).all()
        else:
            l, r = bvh.left[i], bvh.right[i]
            assert l == i + 1, "left child must follow parent (preorder)"
            assert r > l, "right child after left subtree"
            for ch in (l, r):
                assert (bvh.bbox_min[ch] >= bvh.bbox_min[i] - 1e-4).all()
                assert (bvh.bbox_max[ch] <= bvh.bbox_max[i] + 1e-4).all()
    assert seen.all(), "every triangle must appear in exactly one leaf"
