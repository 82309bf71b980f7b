// The split pipeline's traversal kernels for Hopper (sm_90a).
//
// Replace dsrt_tpu/ops/pallas_trace.py `_traverse_kernel` (launched by
// `_run_traverse`) and `_traverse_sun_kernel` (`_run_traverse_sun`), both
// over `_kernel_common`.  They compute what those compute: per ray, the
// closest hit (or any hit) of the binary BVH in [t_min, t_max] with `<=`
// acceptance, as (t, u, v, tri); and, fused into the same thread, the
// any-hit sun-shadow test from the closest hit along the frame's sun
// direction.  The TPU kernels walk one octant per 1024-ray block, chosen
// by majority vote, with scalar node loads broadcast against the block's
// lanes; here ONE THREAD PER RAY walks its own octant of the thread table
// (csrc/walk.cuh, the walk of the path kernel), so the result is the plain
// walk's (`lane_traverse`) ray for ray, ties included.
//
// What bounds it on the H100: each step of the walk is a dependent global
// load (node row -> thread-table entry -> next node row), so a thread is
// latency-bound and neighbouring rays of an incoherent bounce wave walk
// different paths.  The tables are read through the read-only cache in
// 16-byte loads and stay resident in the 50 MB L2 at the scenes the port
// renders (the 51k-triangle stand-in's three tables are ~9 MB); rays are
// read and results written once, structure of arrays, coalesced.  This
// first version takes that simplest form; node caching in shared memory
// and the 8-ary walk are later work.
//
// Plain PyTorch versions: dsrt_tpu_torch/ops/traverse.py
// (`traverse_plain`, `traverse_with_sun_plain`).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "walk.cuh"

namespace dsrt {

constexpr int TRAVERSE_THREADS = 256;

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const uint8_t* active;
};

struct HitOut {
  float *t, *u, *v;
  int* tri;
};

__device__ __forceinline__ void load_ray(const Rays& r, int i, f3& o, f3& d) {
  o = mk(r.ox[i], r.oy[i], r.oz[i]);
  d = mk(r.dx[i], r.dy[i], r.dz[i]);
}

__device__ __forceinline__ void store_hit(const HitOut& out, int i, const WalkHit& h) {
  out.t[i] = h.t;
  out.u[i] = h.u;
  out.v[i] = h.v;
  out.tri[i] = h.tri;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(TRAVERSE_THREADS)
    traverse_kernel(Tables tb, Rays r, HitOut out, int n, float t_min, float t_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  WalkHit h{t_max, 0.0f, 0.0f, -1};
  if (r.active[i]) {
    f3 o, d;
    load_ray(r, i, o, d);
    h = walk<kAnyHit>(tb, o, d, t_min, t_max);
  }
  store_hit(out, i, h);
}

// Closest hit, then the shadow any-hit from o + t d + bias n toward the
// sun on the hit lanes, n the face-flipped geometric normal of the winning
// row (pallas_trace.py:248-260, :298-301).  sun = (Ldir, bias).
__global__ void __launch_bounds__(TRAVERSE_THREADS)
    traverse_sun_kernel(Tables tb, Rays r, HitOut out, uint8_t* blocked, const float* sun,
                        int n, float t_min, float t_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  WalkHit h{t_max, 0.0f, 0.0f, -1};
  bool blk = false;
  if (r.active[i]) {
    f3 o, d;
    load_ray(r, i, o, d);
    h = walk<false>(tb, o, d, t_min, t_max);
    if (h.tri >= 0) {
      const float* tp = tb.tri + (size_t)h.tri * 16;
      const float e1x = __ldg(tp + 3), e1y = __ldg(tp + 4), e1z = __ldg(tp + 5);
      const float e2x = __ldg(tp + 6), e2y = __ldg(tp + 7), e2z = __ldg(tp + 8);
      float gx = e1y * e2z - e1z * e2y;
      float gy = e1z * e2x - e1x * e2z;
      float gz = e1x * e2y - e1y * e2x;
      const float gl = 1.0f / sqrtf(gx * gx + gy * gy + gz * gz + 1e-38f);
      gx = gx * gl;
      gy = gy * gl;
      gz = gz * gl;
      const float sgn = (d.x * gx + d.y * gy + d.z * gz < 0.0f) ? 1.0f : -1.0f;
      const float bias = __ldg(sun + 3);
      const f3 so = mk(o.x + h.t * d.x + bias * (sgn * gx), o.y + h.t * d.y + bias * (sgn * gy),
                       o.z + h.t * d.z + bias * (sgn * gz));
      const f3 ldir = mk(__ldg(sun), __ldg(sun + 1), __ldg(sun + 2));
      blk = walk<true>(tb, so, ldir, t_min, t_max).tri >= 0;
    }
  }
  store_hit(out, i, h);
  blocked[i] = blk ? 1 : 0;
}

}  // namespace dsrt

extern "C" {

int dsrt_traverse(const float* bvh, const float* thr, const float* tri, const float* ox,
                  const float* oy, const float* oz, const float* dx, const float* dy,
                  const float* dz, const uint8_t* active, float* t_out, float* u_out,
                  float* v_out, int* tri_out, int n, int end, int tri_rows, int any_hit,
                  float t_min, float t_max, void* stream) {
  dsrt::Tables tb{bvh, thr, tri, end, tri_rows};
  dsrt::Rays r{ox, oy, oz, dx, dy, dz, active};
  dsrt::HitOut out{t_out, u_out, v_out, tri_out};
  const int blocks = (n + dsrt::TRAVERSE_THREADS - 1) / dsrt::TRAVERSE_THREADS;
  if (blocks > 0) {
    if (any_hit)
      dsrt::traverse_kernel<true><<<blocks, dsrt::TRAVERSE_THREADS, 0, (cudaStream_t)stream>>>(
          tb, r, out, n, t_min, t_max);
    else
      dsrt::traverse_kernel<false><<<blocks, dsrt::TRAVERSE_THREADS, 0, (cudaStream_t)stream>>>(
          tb, r, out, n, t_min, t_max);
  }
  return (int)cudaGetLastError();
}

int dsrt_traverse_sun(const float* bvh, const float* thr, const float* tri, const float* ox,
                      const float* oy, const float* oz, const float* dx, const float* dy,
                      const float* dz, const uint8_t* active, const float* sun, float* t_out,
                      float* u_out, float* v_out, int* tri_out, uint8_t* blocked, int n,
                      int end, int tri_rows, float t_min, float t_max, void* stream) {
  dsrt::Tables tb{bvh, thr, tri, end, tri_rows};
  dsrt::Rays r{ox, oy, oz, dx, dy, dz, active};
  dsrt::HitOut out{t_out, u_out, v_out, tri_out};
  const int blocks = (n + dsrt::TRAVERSE_THREADS - 1) / dsrt::TRAVERSE_THREADS;
  if (blocks > 0)
    dsrt::traverse_sun_kernel<<<blocks, dsrt::TRAVERSE_THREADS, 0, (cudaStream_t)stream>>>(
        tb, r, out, blocked, sun, n, t_min, t_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
