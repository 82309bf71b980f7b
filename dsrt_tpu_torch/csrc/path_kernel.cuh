// The path-tracing megakernel for Hopper (sm_90a), as a template over the
// features a scene uses.  csrc/path_kernel.cu and csrc/path_kernel_prims.cu
// each compile half of the instances (nvcc runs on both in parallel);
// path_kernel.cu holds the C entry point `dsrt_path_render`.
//
// Replaces dsrt_tpu/ops/pallas_path.py `_path_kernel` (launched by
// `_run_path`) over its whole scope (`fused_supported`): triangle and quad
// scenes with flat or smooth (vn) normals, image textures, up to 12
// spheres with moving centres, 24 quads, 8 area lights (spheres and
// quads) with the light/BRDF mixture, 4 constant media, the equirect
// environment sky, checker / marble / noise procedural textures, the
// directional sun with MIS, thin-lens depth of field and the shutter.
// It computes what that kernel computes in the shape of the CUDA
// reference renderer: ONE THREAD PER PIXEL runs every sample and every
// bounce with per-thread control flow, drawing the per-pixel LCG stream
// (x + y*W) ^ seed ^ salt exactly as the plain renderer's masked lanes do
// (the launch and the walk are described below):
//   - the jitter pair, then the lens-disk draws (aperture on), then one
//     shutter-time draw (shutter open), held for the whole path;
//   - one draw per medium on every intersection query, shadow queries
//     included; three draws per rejection attempt;
//   - the mixture's choose draw, then the light pick and two uniforms
//     (whatever the light's kind), or the two cosine-hemisphere draws.
// A query is the plain version's order: the BVH walk, then the spheres
// (centre at the path's shutter time), then the quads, each accepting
// t <= closest (so a primitive wins a tie with the triangle before it),
// then the media.  A shadow query answers "blocked" in any order (no
// draws hang on it but the media's), so it tests the primitives first
// and walks the tree only when none blocks.  The TPU kernel's lockstep
// lanes, sample regeneration, primitive pre-pass and one-hot gathers do
// not carry over.
//
// Instances.  The template bits (K_PRIMS: spheres or quads, K_MEDIA,
// K_LIGHTS: the mixture, K_EXTRA: sky, procedural textures, smooth
// normals, lens, shutter) remove whole code paths; within an instance
// the runtime `flags` pick what the scene has.  Instance 0 is the
// flagship's triangle-only path and compiles to the code it had before
// the other features existed.
//
// What bounds it on the H100: the tree walk is a chain of dependent
// global loads, so a thread is latency-bound, and neighbouring pixels
// diverge in depth, material and walk length, so warps run partly idle.
// What the design does about it:
//   - the walk is the exact 8-ary walk of wide_walk.cuh over `wide_pack`
//     (one dependent link per wide node instead of one per binary node);
//   - the launch is persistent: as many blocks of WARPS warps as fit on
//     the card at once, and each warp takes the next TILE_W x TILE_H
//     pixel tile from a global counter until the frame is done, so the
//     SMs stay full to the end of the frame (a grid of fixed blocks left
//     the blocks over the station to run alone at the end) and a warp's
//     pixels form a compact 8x4 patch, which diverges less than a 16x2
//     strip.  A pixel still runs all its samples in order in one thread,
//     so its draws and its float sums are the plain version's; ray counts
//     are integers and sum exactly in any order.
// The launch over a pixel list (the TPU kernel's lane set, which adaptive
// sampling renders): with `pix` set, a warp takes the next 32 entries of
// the list of flat indices y * width + x in place of the next tile and
// writes pixel i's sum to row i of an (n, 3) accumulator.  The wrapper
// orders the list by (8x4 tile, lane in tile), so where the set is dense
// a warp's 32 entries are one tile as in the frame launch.  It is a
// run-time pointer, not a template bit, so the instances stay 16.
// The primitive records every thread loops over sit in __constant__
// memory (a warp's uniform read is one broadcast), copied there from the
// scene's packed parameter buffer on the launch's stream; the tables are
// read with __ldg.
//
// Plain PyTorch version: dsrt_tpu_torch/ops/path_kernel.py
// (path_render_plain) over ops/shade.py, ops/trace.py, ops/textures.py.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "prims.cuh"
#include "wide_walk.cuh"

namespace dsrt {
namespace path {

constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIELECTRIC = 2;
constexpr int DIFFUSE_LIGHT = 3;

constexpr int WARPS = 4;  // warps a block
constexpr int TILE_W = 8;  // a warp's pixel tile
constexpr int TILE_H = 4;
static_assert(TILE_W * TILE_H == 32, "one pixel a lane");

constexpr int MAX_SPH = 12;
constexpr int MAX_QUADS = 24;
constexpr int MAX_LIGHTS = 8;
constexpr int MAX_MED = 4;

// template bits: the instance
constexpr unsigned K_PRIMS = 1, K_MEDIA = 2, K_LIGHTS = 4, K_EXTRA = 8;
constexpr int N_INSTANCES = 16;
// runtime bits of PathArgs::flags
constexpr unsigned SUN_ON = 1, TEXTURED = 2, ENV = 4, PTEX = 8, SMOOTH = 16, APERTURE = 32,
                   SHUTTER = 64, MOVING = 128;

// the scene's primitive records, packed once per scene by
// ops/path_kernel.py (layouts in prims.cuh; a light is its kind, 0 sphere
// or 1 quad, and its row)
struct Params {
  float sph[MAX_SPH][8];
  float quad[MAX_QUADS][18];
  float lit[MAX_LIGHTS][2];
  float med[MAX_MED][15];
};
static_assert(sizeof(Params) == 604 * sizeof(float), "parameter layout");

struct PathArgs {
  WideTables tb;
  const float* tri_shade;
  const float* tri_aux;
  const float* mat;
  const float* pool;
  const int* tex_w;
  const int* tex_h;
  const int* tex_off;
  const float* cam;  // origin, lower_left, horizontal, vertical, u, v, lens r
  const float* sun;  // Ldir (3), radiance (3), shadow bias
  const int* pix;    // null (the frame) or n_pix flat indices y * width + x
  float* accum;      // [height][width][3], or [n_pix][3] with pix
  unsigned long long* nrays;
  unsigned* next_tile;  // zero at launch: the tile (or list unit) counter
  int width, height;  // pixel grid
  int n_pix;
  int cam_w, cam_h;   // camera raster (seeding and raygen)
  int spp;
  uint32_t salt, seed;
  int max_depth, rr_start;
  float rr_max_p, t_min, t_max;
  int n_textures, pool_n;
  int n_sph, n_quads, n_lights, n_med, env;
  unsigned flags;
  float env_rot, env_scale, time0, dt;
};

// Everything below up to the launchers' declarations has internal
// linkage: each translation unit has its own constant bank, which its own
// instances read and its own launcher fills.
namespace {

__constant__ Params P;

// the closest hit of one query
struct QueryHit {
  bool hit;
  float t;
  int tri;      // tri_pack row of a triangle hit, else -1
  float u, v;   // its barycentrics
  f3 n;         // face-flipped normal of a primitive hit
  bool front;
  int mat;
  int med;      // medium index, -1 for a surface
};

template <unsigned M>
__device__ __forceinline__ QueryHit closest_hit(const PathArgs& a, f3 ro, f3 rd, float tm,
                                                uint32_t& st) {
  constexpr bool kPrims = (M & K_PRIMS) != 0;
  constexpr bool kMedia = (M & K_MEDIA) != 0;
  WalkHit w = wide_walk<false>(a.tb, ro, rd, a.t_min, a.t_max);
  QueryHit h{w.tri >= 0, w.t, w.tri, w.u, w.v, mk(0.0f, 0.0f, 0.0f), false, 0, -1};
  float av = 0.0f;
  if constexpr (kPrims || kMedia) av = dot(rd, rd);
  if constexpr (kPrims) {
    const bool moving = (a.flags & MOVING) != 0;
    for (int i = 0; i < a.n_sph; ++i) {
      float root;
      f3 c;
      if (!sphere_root(P.sph[i], moving, ro, rd, av, tm, a.t_min, h.t, root, c)) continue;
      h.n = sphere_normal(P.sph[i], ro, rd, root, c, h.front);
      h.hit = true;
      h.t = root;
      h.tri = -1;
      h.mat = (int)P.sph[i][4];
    }
    for (int j = 0; j < a.n_quads; ++j) {
      float t;
      bool front;
      if (!quad_hit(P.quad[j], ro, rd, a.t_min, h.t, t, front)) continue;
      const float sgn = front ? 1.0f : -1.0f;
      h.n = mk(sgn * P.quad[j][9], sgn * P.quad[j][10], sgn * P.quad[j][11]);
      h.front = front;
      h.hit = true;
      h.t = t;
      h.tri = -1;
      h.mat = (int)P.quad[j][16];
    }
  }
  if constexpr (kMedia) {
    const float rlen = sqrtf(av);
    for (int i = 0; i < a.n_med; ++i) {
      float u = draw(st);
      float t;
      if (medium_hit(P.med[i], ro, rd, av, rlen, a.t_min, h.t, u, t)) {
        h.hit = true;
        h.t = t;
        h.tri = -1;
        h.med = i;
      }
    }
  }
  return h;
}

// sun shadow query from o along the unit Ldir d: blocked by a primitive,
// a triangle or a medium; every medium still draws
template <unsigned M>
__device__ __forceinline__ bool sun_blocked(const PathArgs& a, f3 o, f3 d, float tm,
                                            uint32_t& st) {
  constexpr bool kPrims = (M & K_PRIMS) != 0;
  constexpr bool kMedia = (M & K_MEDIA) != 0;
  bool hit = false;
  float av = 0.0f;
  if constexpr (kPrims || kMedia) av = dot(d, d);
  if constexpr (kPrims) {
    hit = spheres_block(P.sph, a.n_sph, (a.flags & MOVING) != 0, o, d, av, tm, a.t_min, a.t_max) ||
          quads_block(P.quad, a.n_quads, o, d, a.t_min, a.t_max);
  }
  if (!hit) hit = wide_walk<true>(a.tb, o, d, a.t_min, a.t_max).tri >= 0;
  if constexpr (kMedia) hit = media_block(P.med, a.n_med, o, d, av, a.t_min, a.t_max, hit, st);
  return hit;
}

// the shading normal of a smooth triangle hit: the barycentric blend of
// its vertex normals (tri_aux), normalised by 1 / max(len, 1e-38), then
// face-flipped by its own front flag
__device__ __forceinline__ f3 smooth_normal(const float* tri_aux, int tri, float u, float v, f3 rd,
                                            bool& front) {
  const float* ta = tri_aux + (size_t)tri * 16;
  float wb = 1.0f - u - v;
  float nx = wb * __ldg(ta + 0) + u * __ldg(ta + 3) + v * __ldg(ta + 6);
  float ny = wb * __ldg(ta + 1) + u * __ldg(ta + 4) + v * __ldg(ta + 7);
  float nz = wb * __ldg(ta + 2) + u * __ldg(ta + 5) + v * __ldg(ta + 8);
  float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
  float ninv = nlen > 0.0f ? 1.0f / nmax(nlen, 1e-38f) : 0.0f;
  nx = nx * ninv;
  ny = ny * ninv;
  nz = nz * ninv;
  front = (rd.x * nx + rd.y * ny + rd.z * nz) < 0.0f;
  float sgn = front ? 1.0f : -1.0f;
  return mk(sgn * nx, sgn * ny, sgn * nz);
}

// direction to light-list entry k from p and its solid-angle pdf
__device__ __forceinline__ f3 light_sample(int k, f3 p, float u1, float u2, float& pdf) {
  const int row = (int)P.lit[k][1];
  if (P.lit[k][0] == 0.0f) {
    const float* s = P.sph[row];
    return sphere_light_sample(mk(s[0], s[1], s[2]), s[3], p, u1, u2, pdf);
  }
  return quad_light_sample(P.quad[row], P.quad[row][17], p, u1, u2, pdf);
}

// One sample to completion (ops/shade.py trace_paths for one lane);
// returns clamp01(L) and adds the rays it traced to `rays`.
template <unsigned M>
__device__ f3 trace_path(const PathArgs& a, f3 ro, f3 rd, float tm, uint32_t& st, unsigned& rays) {
  constexpr bool kPrims = (M & K_PRIMS) != 0;
  constexpr bool kMedia = (M & K_MEDIA) != 0;
  constexpr bool kLights = (M & K_LIGHTS) != 0;
  constexpr bool kExtra = (M & K_EXTRA) != 0;
  const f3 sdir = mk(a.sun[0], a.sun[1], a.sun[2]);
  const f3 srad = mk(a.sun[3], a.sun[4], a.sun[5]);
  const float bias = a.sun[6];
  f3 L = mk(0.0f, 0.0f, 0.0f);
  f3 thr = mk(1.0f, 1.0f, 1.0f);
  for (int depth = 0; depth < a.max_depth; ++depth) {
    // 0. Russian roulette
    if (depth >= a.rr_start) {
      float u_rr = draw(st);
      float p_rr = nmin(nmax(thr.x, nmax(thr.y, thr.z)), a.rr_max_p);
      if (u_rr > p_rr) break;
      float inv_p = 1.0f / (p_rr > 0.0f ? p_rr : 1.0f);
      thr = scale(thr, inv_p);
    }
    // 1. closest hit; a miss sees the sky (black without one)
    ++rays;
    QueryHit h = closest_hit<M>(a, ro, rd, tm, st);
    if (!h.hit) {
      if constexpr (kExtra) {
        if (a.flags & ENV)
          L = add(L, mul(thr, sample_env(a.pool, a.tex_w, a.tex_h, a.tex_off, a.n_textures,
                                         a.pool_n, a.env, a.env_rot, a.env_scale, rd)));
      }
      break;
    }
    const f3 p = mk(ro.x + h.t * rd.x, ro.y + h.t * rd.y, ro.z + h.t * rd.z);
    // medium scatter: isotropic, throughput *= medium albedo
    if constexpr (kMedia) {
      if (h.med >= 0) {
        const float* m = P.med[h.med];
        thr = mul(thr, mk(m[12], m[13], m[14]));
        ro = p;
        rd = normalize(random_in_unit_sphere(st));
        continue;
      }
    }
    f3 n = h.n;
    bool front = h.front;
    int mat = h.mat, tex = -1;
    float tu = 0.0f, tv = 0.0f;
    if (!kPrims || h.tri >= 0) {
      SurfaceHit s = assemble(a.tri_shade, WalkHit{h.t, h.u, h.v, h.tri}, rd);
      n = s.n;
      front = s.front;
      mat = s.mat;
      tex = s.tex;
      tu = s.tu;
      tv = s.tv;
      if constexpr (kExtra) {
        if (a.flags & SMOOTH) n = smooth_normal(a.tri_aux, h.tri, h.u, h.v, rd, front);
      }
    }
    const float* mp = a.mat + (size_t)mat * 16;
    const int mtype = (int)__ldg(mp);
    // 2. emission
    if (mtype == DIFFUSE_LIGHT) {
      L = add(L, mul(thr, mk(__ldg(mp + 4), __ldg(mp + 5), __ldg(mp + 6))));
      break;
    }
    // 3. albedo: image texel, then the procedural texture
    f3 albedo = mk(__ldg(mp + 1), __ldg(mp + 2), __ldg(mp + 3));
    if ((a.flags & TEXTURED) && tex >= 0)
      albedo = mul(albedo, sample_texel(a.pool, a.tex_w, a.tex_h, a.tex_off, a.n_textures,
                                        a.pool_n, tex, tu, tv));
    if constexpr (kExtra) {
      if (a.flags & PTEX) albedo = procedural(mp, albedo, p);
    }
    // 4. specular
    if (mtype == METAL) {
      f3 unit_in = normalize(rd);
      f3 refl = reflect(unit_in, n);
      float fuzz = clamp01(__ldg(mp + 7));
      f3 fz = random_in_unit_sphere(st);
      f3 dir = add(refl, scale(fz, fuzz));
      if (!(dot(dir, n) > 0.0f)) break;
      thr = mul(thr, albedo);
      ro = p;
      rd = dir;
      continue;
    }
    if (mtype == DIELECTRIC) {
      f3 unit_in = normalize(rd);
      float eta = __ldg(mp + 8);
      if (eta <= 0.0f || !isfinite(eta)) eta = 1.5f;
      float ratio = front ? 1.0f / eta : eta;
      float cos_t = nmin(dot(neg(unit_in), n), 1.0f);
      float sin_t = sqrtf(nmax(1.0f - cos_t * cos_t, 0.0f));
      bool cannot = ratio * sin_t > 1.0f;
      float refl_prob = schlick(cos_t, ratio);
      float u_d = draw(st);
      bool use_refl = cannot || (refl_prob > u_d);
      ro = p;
      rd = use_refl ? reflect(unit_in, n) : refract(unit_in, n, ratio);
      continue;
    }
    if (mtype != LAMBERTIAN) continue;
    // 5. sun MIS with a shadow query from p + bias * n
    if (a.flags & SUN_ON) {
      float cos_sun = nmax(dot(n, sdir), 0.0f);
      if (cos_sun > 0.0f) {
        ++rays;
        f3 sh_o = mk(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z);
        if (!sun_blocked<M>(a, sh_o, sdir, tm, st)) {
          float pdf_brdf_s = cos_sun / PI_F;
          float w_sun = pdf_brdf_s / (0.5f + 0.5f * pdf_brdf_s);
          L = add(L, scale(mul(mul(thr, albedo), srad), w_sun));
        }
      }
    }
    // 6. next direction: cosine sampling, or the light/BRDF mixture
    if constexpr (!kLights) {
      float pdf;
      f3 world = sample_cosine_hemisphere(n, st, pdf);
      if (!(pdf > 0.0f)) break;
      thr = mul(thr, albedo);
      ro = p;
      rd = world;
    } else {
      float choose = draw(st);
      f3 dir;
      float pdf_val;
      bool ok;
      if (choose < 0.5f) {
        float uk = draw(st);
        int k = min((int)(uk * (float)a.n_lights), a.n_lights - 1);
        float u1 = draw(st);
        float u2 = draw(st);
        float pdf_lc;
        dir = light_sample(k, p, u1, u2, pdf_lc);
        float cos_li = nmax(dot(dir, n), 0.0f);
        ok = pdf_lc > 0.0f && cos_li > 0.0f;
        pdf_val = 0.5f * (pdf_lc / (float)a.n_lights) + 0.5f * (cos_li / PI_F);
      } else {
        float pdf_b;
        dir = sample_cosine_hemisphere(n, st, pdf_b);
        ok = pdf_b > 0.0f;
        pdf_val = 0.5f * pdf_b;
      }
      if (!ok) break;
      float cos_o = nmax(dot(dir, n), 0.0f);
      float weight = (cos_o / PI_F) / (pdf_val > 0.0f ? pdf_val : 1.0f);
      thr = scale(mul(thr, albedo), weight);
      ro = p;
      rd = dir;
    }
  }
  return mk(clamp01(L.x), clamp01(L.y), clamp01(L.z));
}

// every sample of pixel (x, y); returns the sum of clamp01(L)
template <unsigned M>
__device__ __forceinline__ f3 render_pixel(const PathArgs& a, int x, int y,
                                           unsigned long long& rays) {
  constexpr bool kExtra = (M & K_EXTRA) != 0;
  uint32_t st = ((uint32_t)x + (uint32_t)y * (uint32_t)a.cam_w) ^ a.seed ^ a.salt;
  const float* cam = a.cam;
  const float spp_f = (float)a.spp;
  const float wm1 = (float)(a.cam_w - 1), hm1 = (float)(a.cam_h - 1);
  f3 acc = mk(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < a.spp; ++s) {
    float jxu = draw(st);
    float jyu = draw(st);
    float sf = (float)s;
    float jx = (sf + jxu) / spp_f;
    float jy = (sf + jyu) / spp_f;
    float u = ((float)x + jx) / wm1;
    float v = ((float)y + jy) / hm1;
    f3 ro = mk(cam[0], cam[1], cam[2]);
    f3 rd = mk(cam[3] + u * cam[6] + v * cam[9] - cam[0],
               cam[4] + u * cam[7] + v * cam[10] - cam[1],
               cam[5] + u * cam[8] + v * cam[11] - cam[2]);
    float tm = 0.0f;
    if constexpr (kExtra) {
      if (a.flags & APERTURE) {  // thin lens: offset on the camera's (u, v) basis
        float dx, dy;
        random_in_unit_disk(st, dx, dy);
        float lrx = cam[18] * dx;
        float lry = cam[18] * dy;
        f3 off = mk(cam[12] * lrx + cam[15] * lry, cam[13] * lrx + cam[16] * lry,
                    cam[14] * lrx + cam[17] * lry);
        ro = add(ro, off);
        rd = sub(rd, off);
      }
      if (a.flags & SHUTTER) tm = a.time0 + draw(st) * a.dt;
    }
    unsigned r = 0;
    acc = add(acc, trace_path<M>(a, ro, rd, tm, st, r));
    rays += r;
  }
  return acc;
}

// persistent warps: each takes the next unit of 32 pixels (an 8x4 tile of
// the frame, or 32 entries of the pixel list) until none is left
template <unsigned M>
__global__ void __launch_bounds__(32 * WARPS) path_render_kernel(const PathArgs a) {
  const int lane = threadIdx.x & 31;
  const int tiles_x = (a.width + TILE_W - 1) / TILE_W;
  const unsigned n_units =
      a.pix ? ((unsigned)a.n_pix + 31u) / 32u
            : (unsigned)(tiles_x * ((a.height + TILE_H - 1) / TILE_H));
  // each thread's row of accum waits here (volatile: not forwarded into
  // a register) while it renders, so that the render keeps the frame
  // launch's registers
  __shared__ unsigned rows_mem[32 * WARPS];
  volatile unsigned* rows = rows_mem;
  unsigned long long rays = 0;
  for (;;) {
    unsigned unit = 0;
    if (lane == 0) unit = atomicAdd(a.next_tile, 1u);
    unit = __shfl_sync(0xffffffffu, unit, 0);
    if (unit >= n_units) break;
    int x, y;
    bool live;
    if (a.pix) {
      const unsigned i = unit * 32u + (unsigned)lane;
      live = i < (unsigned)a.n_pix;
      const int p = live ? __ldg(a.pix + i) : 0;
      x = p % a.width;
      y = p / a.width;
      rows[threadIdx.x] = i;
    } else {
      x = (int)(unit % (unsigned)tiles_x) * TILE_W + lane % TILE_W;
      y = (int)(unit / (unsigned)tiles_x) * TILE_H + lane / TILE_W;
      live = x < a.width && y < a.height;
      rows[threadIdx.x] = (unsigned)(y * a.width + x);
    }
    if (live) {
      const f3 acc = render_pixel<M>(a, x, y, rays);
      float* out = a.accum + (size_t)rows[threadIdx.x] * 3;
      out[0] = acc.x;
      out[1] = acc.y;
      out[2] = acc.z;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rays += __shfl_down_sync(0xffffffffu, rays, off);
  if (lane == 0 && rays) atomicAdd(a.nrays, rays);
}

using KernelFn = void (*)(PathArgs);

// copy the scene's records into this translation unit's constant bank
// (scenes with primitives, media or lights) and launch `fn`
int launch_instance(KernelFn fn, unsigned m, const PathArgs& a, const float* params,
                           cudaStream_t s) {
  if (m & (K_PRIMS | K_MEDIA | K_LIGHTS)) {
    cudaError_t err =
        cudaMemcpyToSymbolAsync(P, params, sizeof(Params), 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * WARPS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  dim3 block(32 * WARPS);
  dim3 grid(sms * per_sm);
  PathArgs copy = a;
  void* args[] = {&copy};
  cudaError_t err = cudaLaunchKernel((const void*)fn, grid, block, args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// the instances without (path_kernel.cu) and with (path_kernel_prims.cu)
// spheres and quads
int launch_plain_geometry(unsigned m, const PathArgs& a, const float* params, cudaStream_t s);
int launch_primitives(unsigned m, const PathArgs& a, const float* params, cudaStream_t s);
// instance m's kernel (m < N_INSTANCES, its K_PRIMS bit picking the unit)
KernelFn plain_geometry_kernel(unsigned m);
KernelFn primitives_kernel(unsigned m);

}  // namespace path
}  // namespace dsrt
