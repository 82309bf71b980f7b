// The split pipeline's traversal kernels for Hopper (sm_90a).
//
// Replace dsrt_tpu/ops/pallas_trace.py `_traverse_kernel` (launched by
// `_run_traverse`) and `_traverse_sun_kernel` (`_run_traverse_sun`), both
// over `_kernel_common`.  They compute what those compute: per ray, the
// closest hit (or any hit) of the scene's BVH in [t_min, t_max] with `<=`
// acceptance, as (t, u, v, tri); and, fused into the same thread, the
// any-hit sun-shadow test from the closest hit along the frame's sun
// direction.  The TPU kernels walk one octant per 1024-ray block, chosen
// by majority vote, with scalar node loads broadcast against the block's
// lanes; here ONE THREAD PER RAY walks its own octant, so the result is
// the plain walk's (`lane_traverse`) ray for ray, ties included.
//
// What bounds it on the H100.  A walk is a chain of dependent loads, and
// neighbouring rays of an incoherent bounce wave walk different paths;
// the tables stay in the 50 MB L2 at the scenes the port renders (the
// 51k-triangle stand-in's are ~9 MB).  The split waves launch on 1.5M
// lanes of which often under 10% are active, and drain on 95k lanes, a
// third of the card's resident warps: there a launch lasts as long as its
// longest chain.  So the kernels walk the path kernel's exact 8-ary
// table `wide_pack` (csrc/wide_walk.cuh): a wide visit issues its 16
// child loads at once, one link of the chain where the binary walk
// (csrc/walk.cuh) takes 2.5 to 5.8 (the stand-in's split waves).  First
// the ray is tested against the binary root's box, the binary walk's
// first step: a ray that misses the scene then costs one slab test,
// not eight.  Both walks scan the same leaves in the same order with the
// same `<=` ties, so the closest hit is the same; an any-hit query may
// stop at another occluder, and only its mask (`tri >= 0`) is the
// contract.  The sun query runs its two walks through one inlined walk
// (a run-time any-hit flag), so the wide walk's code is in the kernel
// once.  The wide instances hold 64 registers (launch bounds for 4
// blocks of 256; unbounded they take ~90 and fit 2) and a per-thread
// stack of WIDE_STACK entries in local memory; 5 blocks spill and run
// three times slower.  A scene whose `wide_stack` is deeper than
// WIDE_STACK takes the binary instances (ops/traverse.py `walk_of`), 48
// registers, 5 blocks.  Rays are read and results written once,
// structure of arrays, coalesced; a component that is one value for
// every ray (a shadow query's sun direction) is read from one address.
// `active` is a torch.bool tensor read as bytes, `tri` is written as
// int64 and `blocked` as bool bytes, so the wrapper converts nothing.
// PERF.md has the times of these and of the parts dropped.
//
// Plain PyTorch versions: dsrt_tpu_torch/ops/traverse.py
// (`traverse_plain`, `traverse_with_sun_plain`).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "walk.cuh"
#include "wide_walk.cuh"

namespace dsrt {

constexpr int TRAVERSE_THREADS = 256;
// query kinds (template argument and the C entry's `kind`)
constexpr int CLOSEST = 0, ANY_HIT = 1, SUN = 2;

struct Rays {
  const float* c[6];      // ox, oy, oz, dx, dy, dz
  unsigned bcast;         // bit k: component k is one value for every ray
  const uint8_t* active;  // torch.bool bytes
};

struct TraverseArgs {
  Tables bin;       // the binary walk's tables (walk.cuh); row 0's box
  WideTables wide;  // the 8-ary walk's (wide_walk.cuh)
  Rays r;
  float *t, *u, *v;
  long long* tri;
  uint8_t* blocked;  // torch.bool bytes (SUN only)
  const float* sun;  // Ldir, bias (SUN only)
  int n;
  float t_min, t_max;
};

__device__ __forceinline__ float comp(const Rays& r, int k, int i) {
  return __ldg(r.c[k] + (((r.bcast >> k) & 1u) ? 0 : i));
}

// walk.cuh's slab test of the binary root (node 0) against [t_min, t_max]:
// the binary walk's first step.  A ray that misses it misses every box
// of the wide table too, whose boxes lie inside the root's.
__device__ __forceinline__ bool enters_root(const Tables& tb, f3 o, f3 d, float t_min,
                                            float t_max) {
  const float4* row = reinterpret_cast<const float4*>(tb.bvh);
  const float4 p = __ldg(row), q = __ldg(row + 1);
  const float inv[3] = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  const float org[3] = {o.x, o.y, o.z};
  const float bmin[3] = {p.x, p.y, p.z};
  const float bmax[3] = {p.w, q.x, q.y};
  float lo = t_min, hi = t_max;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float t0 = (bmin[ax] - org[ax]) * inv[ax];
    float t1 = (bmax[ax] - org[ax]) * inv[ax];
    bool negd = inv[ax] < 0.0f;
    lo = nmax(lo, negd ? t1 : t0);
    hi = nmin(hi, negd ? t0 : t1);
  }
  return hi > lo;
}

// One query on the 8-ary walk: kMode as wide_walk_mode's.
template <int kMode>
__device__ __forceinline__ WalkHit wide_query(const TraverseArgs& a, f3 o, f3 d, bool any_hit) {
  if (a.bin.end > 0 && !enters_root(a.bin, o, d, a.t_min, a.t_max))
    return WalkHit{a.t_max, 0.0f, 0.0f, -1};
  return wide_walk_mode<kMode>(a.wide, o, d, a.t_min, a.t_max, any_hit);
}

// The shadow origin o + t d + bias n of a closest hit, n the face-flipped
// geometric normal of its row (pallas_trace.py:248-260, :298-301), in
// ops/traverse.py `sun_origin`'s order; sun = (Ldir, bias).
__device__ __forceinline__ f3 shadow_origin(const TraverseArgs& a, f3 o, f3 d, const WalkHit& h) {
  const float* tp = a.bin.tri + (size_t)h.tri * 16;
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
  const float bias = __ldg(a.sun + 3);
  return mk(o.x + h.t * d.x + bias * (sgn * gx), o.y + h.t * d.y + bias * (sgn * gy),
            o.z + h.t * d.z + bias * (sgn * gz));
}

// Ray i: the query of kind kKind on the 8-ary (kWide) or the binary walk,
// its outputs stored.  SUN: the closest hit, then on a hit the any-hit
// walk from `shadow_origin` toward the sun.
template <int kKind, bool kWide>
__device__ __forceinline__ void trace_ray(const TraverseArgs& a, int i) {
  WalkHit h{a.t_max, 0.0f, 0.0f, -1};
  bool blk = false;
  if (a.r.active[i]) {
    const f3 o = mk(comp(a.r, 0, i), comp(a.r, 1, i), comp(a.r, 2, i));
    const f3 d = mk(comp(a.r, 3, i), comp(a.r, 4, i), comp(a.r, 5, i));
    if (kKind != SUN) {
      h = kWide ? wide_query<kKind == ANY_HIT ? 1 : 0>(a, o, d, kKind == ANY_HIT)
                : walk<kKind == ANY_HIT>(a.bin, o, d, a.t_min, a.t_max);
    } else if (kWide) {
      f3 qo = o, qd = d;
      for (int pass = 0; pass < 2; ++pass) {
        const WalkHit w = wide_query<2>(a, qo, qd, pass == 1);
        if (pass == 1) {
          blk = w.tri >= 0;
        } else {
          h = w;
          if (h.tri < 0) break;
          qo = shadow_origin(a, o, d, h);
          qd = mk(__ldg(a.sun), __ldg(a.sun + 1), __ldg(a.sun + 2));
        }
      }
    } else {
      h = walk<false>(a.bin, o, d, a.t_min, a.t_max);
      if (h.tri >= 0)
        blk = walk<true>(a.bin, shadow_origin(a, o, d, h),
                         mk(__ldg(a.sun), __ldg(a.sun + 1), __ldg(a.sun + 2)), a.t_min, a.t_max)
                  .tri >= 0;
    }
  }
  a.t[i] = h.t;
  a.u[i] = h.u;
  a.v[i] = h.v;
  a.tri[i] = h.tri;
  if (kKind == SUN) a.blocked[i] = blk ? 1 : 0;
}

// One thread per ray.
template <int kKind, bool kWide>
__global__ void __launch_bounds__(TRAVERSE_THREADS, kWide ? 4 : 5)
    traverse_kernel(const TraverseArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) trace_ray<kKind, kWide>(a, i);
}

using TraverseFn = void (*)(TraverseArgs);

// instance = kind + 3 * wide
constexpr int N_INSTANCES = 6;

template <bool kWide>
TraverseFn kernel_of_kind(int kind) {
  return kind == CLOSEST   ? traverse_kernel<CLOSEST, kWide>
         : kind == ANY_HIT ? traverse_kernel<ANY_HIT, kWide>
                           : traverse_kernel<SUN, kWide>;
}

TraverseFn kernel_of(int instance) {
  return instance >= 3 ? kernel_of_kind<true>(instance - 3) : kernel_of_kind<false>(instance);
}

}  // namespace dsrt

extern "C" {

// Resident blocks of TRAVERSE_THREADS per SM of instance kind + 3 * wide
// (negative: a CUDA error).
int dsrt_traverse_occupancy(int instance) {
  if (instance < 0 || instance >= dsrt::N_INSTANCES) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dsrt::kernel_of(instance), dsrt::TRAVERSE_THREADS, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

// kind: 0 closest, 1 any hit, 2 closest plus the sun-shadow any-hit;
// walk_wide: walk wide_pack (after bvh_pack's root box), else bvh_pack /
// thr_pack.  Components whose bit is set in `bcast` are one value for
// every ray.
int dsrt_traverse(const float* bvh, const float* thr, const float* wide, const float* tri,
                  const float* ox, const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const uint8_t* active, const float* sun,
                  float* t_out, float* u_out, float* v_out, long long* tri_out, uint8_t* blocked,
                  int n, int end, int n_wide, int tri_rows, int bcast, int kind, int walk_wide,
                  float t_min, float t_max, void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  dsrt::TraverseArgs a{{bvh, thr, tri, end, tri_rows},
                       {wide, tri, n_wide, tri_rows},
                       {{ox, oy, oz, dx, dy, dz}, (unsigned)bcast, active},
                       t_out, u_out, v_out, tri_out, blocked, sun, n, t_min, t_max};
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + dsrt::TRAVERSE_THREADS - 1) / dsrt::TRAVERSE_THREADS;
  void* args[] = {&a};
  cudaError_t e =
      cudaLaunchKernel((const void*)dsrt::kernel_of(kind + 3 * (walk_wide ? 1 : 0)), dim3(blocks),
                       dim3(dsrt::TRAVERSE_THREADS), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
