// Per-thread stackless BVH walk over the octant thread table, and hit
// assembly.  Port of dsrt_tpu/ops/trace.py lane_traverse (:465-590) and
// hit_from_kernel (:652-683); the plain version is
// dsrt_tpu_torch/ops/trace.py.
//
// Tables (row-major float32, 16 floats = 64 bytes a row):
//   bvh_pack[node]  : box min (0-2), box max (3-5), skip, leaf offset (7),
//                     leaf count (8) — only columns 0-8 are read;
//   thr_pack[node]  : (enter, skip) pairs, lanes [2o, 2o+1] for octant o;
//   tri_pack[row]   : v0 (0-2), e1 (3-5), e2 (6-8), ... — lanes 13-15 hold
//                     bf16 UV pairs as bit patterns and are never read here;
//   tri_shade[row]  : normal (0-2), uv0 (3-4), uv1 (5-6), uv2 (7-8),
//                     material (9), texture (10).
//
// The walk visits nodes in the reference's per-octant order and accepts
// leaf rows with `<=` against the running closest t, so ties resolve to
// the same triangle as the plain version.
#pragma once

#include "common.cuh"

namespace dsrt {

struct Tables {
  const float* bvh;
  const float* thr;
  const float* tri;
  int end;        // number of binary BVH nodes: the walk's terminal index
  int tri_rows;   // rows of tri_pack
};

struct WalkHit {
  float t, u, v;
  int tri;  // tri_pack row, -1 = miss
};

// Closest hit (any_hit = false) or first occluder (any_hit = true) in
// [t_min, t_max].  With any_hit the walk stops at the first accept; only
// `tri >= 0` is meaningful then.
template <bool kAnyHit>
__device__ WalkHit walk(const Tables& tb, f3 o, f3 d, float t_min, float t_max) {
  WalkHit h{t_max, 0.0f, 0.0f, -1};
  if (tb.end <= 0) return h;
  const float inv[3] = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const float org[3] = {o.x, o.y, o.z};
  const int oct = (d.x < 0.0f) + 2 * (d.y < 0.0f) + 4 * (d.z < 0.0f);
  float closest = t_max;
  int node = 0;
  while (node < tb.end) {
    const float4* row = reinterpret_cast<const float4*>(tb.bvh + (size_t)node * 16);
    const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
    const float bmin[3] = {a.x, a.y, a.z};
    const float bmax[3] = {a.w, b.x, b.y};
    float tmin_c = t_min, tmax_c = closest;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      float t0 = (bmin[ax] - org[ax]) * inv[ax];
      float t1 = (bmax[ax] - org[ax]) * inv[ax];
      bool negd = inv[ax] < 0.0f;
      tmin_c = nmax(tmin_c, negd ? t1 : t0);
      tmax_c = nmin(tmax_c, negd ? t0 : t1);
    }
    const bool enter = tmax_c > tmin_c;
    const int leaf_off = (int)b.w;
    const int leaf_cnt = (int)c.x;
    const bool is_leaf = leaf_cnt > 0;
    if (enter && is_leaf) {
      for (int i = 0; i < leaf_cnt; ++i) {
        int r = min(leaf_off + i, tb.tri_rows - 1);
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
    const float* tt = tb.thr + (size_t)node * 16 + 2 * oct;
    node = (enter && !is_leaf) ? (int)__ldg(tt) : (int)__ldg(tt + 1);
  }
  h.t = h.tri >= 0 ? closest : t_max;
  return h;
}

struct SurfaceHit {
  f3 n;        // face-flipped flat normal
  bool front;
  int mat;
  int tex;
  float tu, tv;
};

__device__ __forceinline__ SurfaceHit assemble(const float* tri_shade, const WalkHit& w,
                                               f3 d) {
  const float* ts = tri_shade + (size_t)w.tri * 16;
  SurfaceHit s;
  float nx = __ldg(ts + 0), ny = __ldg(ts + 1), nz = __ldg(ts + 2);
  float wb = 1.0f - w.u - w.v;
  s.tu = wb * __ldg(ts + 3) + w.u * __ldg(ts + 5) + w.v * __ldg(ts + 7);
  s.tv = wb * __ldg(ts + 4) + w.u * __ldg(ts + 6) + w.v * __ldg(ts + 8);
  s.mat = (int)__ldg(ts + 9);
  s.tex = (int)__ldg(ts + 10);
  s.front = (d.x * nx + d.y * ny + d.z * nz) < 0.0f;
  float sgn = s.front ? 1.0f : -1.0f;
  s.n = mk(sgn * nx, sgn * ny, sgn * nz);
  return s;
}

}  // namespace dsrt
