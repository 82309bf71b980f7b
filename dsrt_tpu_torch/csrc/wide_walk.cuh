// The path kernel's BVH walk: an exact 8-ary walk over `wide_pack`, the
// table models/scene.py `pack_wide` makes from the binary tree.  Replaces
// the walk of dsrt_tpu/ops/pallas_path.py `_closest_hit` (:1052, node
// load `_load_wide` :659, 8-child slab test `_visit_bits` :694) for one
// thread; the plain version is dsrt_tpu_torch/ops/trace.py
// `wide_walk_plain`, which equals `lane_traverse` (the binary walk of
// walk.cuh) ray for ray.
//
// Table (row-major float32, WIDE_ROW = 72 floats = 288 bytes a node):
//   floats [8k, 8k+8), child slot k: box min (0-2), box max (3-5), then
//     two int32 bit patterns: a leaf child's first tri_pack row and its
//     count (> 0), or an interior child's wide node index and 0; an
//     empty slot has a zero-width box far away and is never entered;
//   float 64 + o: for ray octant o, the visit rank of each slot in the
//     binary walk's order, 3 bits a slot, an int32 bit pattern.
//
// Why it is exact.  Leaf children are the binary leaves; a binary node
// the walk skips over (collapsed inside a wide node) contains its
// children's boxes, and the slab test rounds monotonically, so a child
// entered implies its collapsed ancestors entered.  A visit computes
// each child's slab interval (lo, hi) in walk.cuh's arithmetic, leaving
// out the running closest t, and pushes the entered children in reverse
// visit order; a pop re-tests nmin(hi, closest) > lo against the current
// closest, exactly as the binary walk tests that box when it reaches it.
// So the same leaves are scanned in the same order with the same `<=`
// ties.
//
// What it changes on the H100.  The binary walk is a chain of dependent
// loads, one node per step (three float4 of bvh_pack, then the next node
// from thr_pack).  A wide visit issues its 16 child float4 and its rank
// word together, so the chain is one link per wide node: on the flagship
// stand-in, 3.4 to 5.9 binary visits per wide visit on a frame's queries
// (dsrt_tpu_torch/tools/path_probe.py `visits_per_query`).  The price is
// 8 slab tests a visit and a per-thread stack in local memory.
#pragma once

#include "common.cuh"
#include "walk.cuh"

namespace dsrt {

constexpr int WIDE_ROW = 72;
// stack entries a thread holds, as deep as the TPU kernel's wide walk
// (pallas_path.py:470); ops/path_kernel.py refuses a scene whose
// `wide_stack` (pack_wide's worst height) exceeds it, so no push can
// overflow.  A walk touches only the entries up to its own depth.
constexpr int WIDE_STACK = 256;

struct WideTables {
  const float* wide;
  const float* tri;
  int n_wide;    // 0: no triangles, a miss at once
  int tri_rows;  // rows of tri_pack
};

// Closest hit (any_hit = false) or first occluder (any_hit = true) in
// [t_min, t_max], as walk.cuh's walk<kAnyHit> returns it.
template <bool kAnyHit>
__device__ WalkHit wide_walk(const WideTables& tb, f3 o, f3 d, float t_min, float t_max) {
  WalkHit h{t_max, 0.0f, 0.0f, -1};
  if (tb.n_wide <= 0) return h;
  const float inv[3] = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const float org[3] = {o.x, o.y, o.z};
  const int oct = (d.x < 0.0f) + 2 * (d.y < 0.0f) + 4 * (d.z < 0.0f);
  const float inf = __int_as_float(0x7f800000);
  float closest = t_max;
  // (child index or first row, count, lo, hi); the first to visit on top
  float4 stack[WIDE_STACK];
  int sp = 0;
  int node = 0;
  while (node >= 0) {
    // visit: test the 8 children, push the entered ones
    const float* row = tb.wide + (size_t)node * WIDE_ROW;
    const unsigned ranks = __float_as_uint(__ldg(row + 64 + oct));
    const float4* kid = reinterpret_cast<const float4*>(row);
    float lo[8], hi[8], ref[8], cnt[8];
    unsigned vmask = 0;  // bit r: the child of visit rank r is entered
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 p = __ldg(kid + 2 * k), q = __ldg(kid + 2 * k + 1);
      const float bmin[3] = {p.x, p.y, p.z};
      const float bmax[3] = {p.w, q.x, q.y};
      float l = t_min, u = inf;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float t0 = (bmin[ax] - org[ax]) * inv[ax];
        float t1 = (bmax[ax] - org[ax]) * inv[ax];
        bool negd = inv[ax] < 0.0f;
        l = nmax(l, negd ? t1 : t0);
        u = nmin(u, negd ? t0 : t1);
      }
      lo[k] = l;
      hi[k] = u;
      ref[k] = q.z;
      cnt[k] = q.w;
      if (nmin(u, closest) > l) vmask |= 1u << ((ranks >> (3 * k)) & 7u);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned r = (ranks >> (3 * k)) & 7u;
      if ((vmask >> r) & 1u)  // children of a later rank lie below it
        stack[sp + __popc(vmask >> r >> 1)] = make_float4(ref[k], cnt[k], lo[k], hi[k]);
    }
    sp += __popc(vmask);
    // pop: scan entered leaves until an entered interior child
    node = -1;
    while (sp > 0) {
      const float4 e = stack[--sp];
      if (!(nmin(e.w, closest) > e.z)) continue;
      const int first = __float_as_int(e.x), count = __float_as_int(e.y);
      if (count == 0) {
        node = first;
        break;
      }
      for (int i = 0; i < count; ++i) {
        int r = min(first + i, tb.tri_rows - 1);
        const float4* tr = reinterpret_cast<const float4*>(tb.tri + (size_t)r * 16);
        const float4 p0 = __ldg(tr), p1 = __ldg(tr + 1), p2 = __ldg(tr + 2);
        // v0 = p0.xyz, e1 = (p0.w, p1.x, p1.y), e2 = (p1.z, p1.w, p2.x)
        float pvx = d.y * p2.x - d.z * p1.w;
        float pvy = d.z * p1.z - d.x * p2.x;
        float pvz = d.x * p1.w - d.y * p1.z;
        float det = p0.w * pvx + p1.x * pvy + p1.y * pvz;
        bool ok = fabsf(det) >= 1e-8f;
        float inv_det = 1.0f / (ok ? det : 1.0f);
        float tvx = o.x - p0.x;
        float tvy = o.y - p0.y;
        float tvz = o.z - p0.z;
        float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        ok = ok && (u >= 0.0f) && (u <= 1.0f);
        float qvx = tvy * p1.y - tvz * p1.x;
        float qvy = tvz * p0.w - tvx * p1.y;
        float qvz = tvx * p1.x - tvy * p0.w;
        float v = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
        ok = ok && (v >= 0.0f) && (u + v <= 1.0f);
        float t = (p1.z * qvx + p1.w * qvy + p2.x * qvz) * inv_det;
        ok = ok && (t >= t_min) && (t <= closest);
        if (ok) {
          h.u = u;
          h.v = v;
          h.tri = r;
          if (kAnyHit) {
            h.t = t_min;
            return h;
          }
          closest = t;
        }
      }
    }
  }
  h.t = h.tri >= 0 ? closest : t_max;
  return h;
}

}  // namespace dsrt
