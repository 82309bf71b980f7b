// The path-tracing megakernel for sphere-only scenes, for Hopper (sm_90a).
//
// Replaces dsrt_tpu/ops/pallas_sphere.py `_sphere_kernel` (launched by
// `_run_sphere`) over its whole scope: up to 16 spheres with moving
// centres, up to 4 constant media (sphere or box boundary), up to 8
// sphere lights with the reference's asymmetric light/BRDF mixture,
// checker / marble / noise procedural textures over the hash-gradient
// Perlin, the equirect environment sky, the directional sun with MIS,
// thin-lens depth of field and the camera shutter.  Like
// csrc/path_kernel.cu it takes the shape of the CUDA reference renderer:
// ONE THREAD PER PIXEL runs every sample and every bounce with per-thread
// control flow, drawing the per-pixel LCG stream (x + y*W) ^ seed ^ salt
// exactly as the parity renderer's masked lanes do:
//   - the jitter pair, then the lens-disk draws (aperture on), then one
//     shutter-time draw (shutter open), held for the whole path;
//   - one draw per medium on every intersection query, shadow queries
//     included;
//   - three draws per rejection attempt (medium scatter, metal fuzz);
//   - the mixture's choose draw, then the light pick and two uniforms, or
//     the two cosine-hemisphere draws.
// The TPU kernel's lockstep lanes, sample regeneration and one-hot
// gathers do not carry over.
//
// What bounds it on the H100: there is no tree; every query tests every
// sphere and medium, so a thread's time is arithmetic on a short,
// dependent chain, and neighbouring pixels diverge in depth and material.
// The rtiow frame (90,000 pixels) is resident on the card at once, so its
// time is the latency of its longest pixel's bounce chain (2.29 of a 2.30
// ms window); the volumetric frame (360,000 pixels) takes several rounds.
// What the design does about it: the direction samplers' cos and sin are
// exact_math.cuh's short sequence, one reduction for both, proven to
// round as the plain version's float64 calls on every input it receives.
// Measured and not kept (PERF.md, the sphere kernel's redesign): the
// sphere tests four at a time with an in-order select (exact, but the
// volumetric frame ran 29% slower), persistent warps over 8x4 or 16x2
// tiles (rtiow 11-13% slower), the exact log of the free path, a 64-bit
// ray sum and launch bounds for six or seven blocks an SM (each more
// registers or spills, and the volumetric frame slower).
// The scene parameters every thread loops over (spheres, media, lights,
// camera, sun) sit in __constant__ memory, where a warp's uniform read is
// one broadcast; the material rows (indexed per thread) are copied to
// shared memory at block start; the environment map is read with direct
// indexed global loads.  A launch copies the scene's parameter vector
// (packed once per scene by the wrapper) and the camera vector into the
// constant bank on its stream first, so launches are ordered by that
// stream.
//
// The sphere, medium, shadow and procedural-texture device code is
// shared with the path kernel (csrc/prims.cuh).
//
// Plain PyTorch version: dsrt_tpu_torch/ops/sphere_kernel.py
// (sphere_render_plain) over ops/shade.py, ops/trace.py, ops/textures.py.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "prims.cuh"

namespace dsrt {
namespace sph {

constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIELECTRIC = 2;
constexpr int DIFFUSE_LIGHT = 3;

constexpr int MAX_SPH = 16;
constexpr int MAX_MED = 4;
constexpr int MAX_LIGHTS = 8;

constexpr int BLOCK_W = 16;
constexpr int BLOCK_H = 8;

constexpr unsigned SUN_ON = 1, PTEX = 2, APERTURE = 4, SHUTTER = 8, MOVING = 16;

// layout of the parameter vector packed by ops/sphere_kernel.py
struct Params {
  float sph[MAX_SPH][8];      // centre (3), radius, material, centre at t=1 (3)
  float med[MAX_MED][15];     // kind, centre (3), radius, min (3), max (3),
                              // -1/density, albedo (3)
  float lit[MAX_LIGHTS][4];   // centre (3), radius
  float cam[19];              // origin, lower_left, horizontal, vertical, u, v, lens r
  float sun[8];               // Ldir (3), radiance (3), shadow bias, pad
};
static_assert(sizeof(Params) == 247 * sizeof(float), "parameter layout");

__constant__ Params P;

struct Args {
  const float* mat;
  const float* pool;
  const int* tex_w;
  const int* tex_h;
  const int* tex_off;
  float* accum;  // [height][width][3]
  unsigned long long* nrays;
  int width, height, cam_w, cam_h, spp;
  uint32_t salt, seed;
  int max_depth, rr_start;
  int n_mats, n_sph, n_med, n_lights, env, n_textures, pool_n;
  unsigned flags;
  float rr_max_p, t_min, t_max, env_rot, env_scale, time0, dt;
};

struct Hit {
  bool hit;
  float t;
  f3 n;  // face-flipped normal
  bool front;
  int mat;
  int med;  // medium index, -1 for a surface
};

// closest hit: spheres in order (later ones win ties), then media
__device__ Hit closest_hit(const Args& a, f3 ro, f3 rd, float tm, uint32_t& st) {
  Hit h{false, a.t_max, mk(0.0f, 0.0f, 0.0f), false, 0, -1};
  const float av = dot(rd, rd);
  const bool moving = (a.flags & MOVING) != 0;
  for (int i = 0; i < a.n_sph; ++i) {
    float root;
    f3 c;
    if (!sphere_root(P.sph[i], moving, ro, rd, av, tm, a.t_min, h.t, root, c)) continue;
    bool front;
    f3 nv = sphere_normal(P.sph[i], ro, rd, root, c, front);
    h = Hit{true, root, nv, front, (int)P.sph[i][4], -1};
  }
  if (a.n_med > 0) {
    const float rlen = sqrtf(av);
    for (int i = 0; i < a.n_med; ++i) {
      float u = draw(st);
      float t;
      if (medium_hit(P.med[i], ro, rd, av, rlen, a.t_min, h.t, u, t))
        h = Hit{true, t, mk(1.0f, 0.0f, 0.0f), true, 0, i};
    }
  }
  return h;
}

// shadow query: blocked by any sphere or medium; every medium still draws
__device__ bool blocked(const Args& a, f3 ro, f3 rd, float tm, uint32_t& st) {
  const float av = dot(rd, rd);
  bool hit = spheres_block(P.sph, a.n_sph, (a.flags & MOVING) != 0, ro, rd, av, tm, a.t_min,
                           a.t_max);
  return media_block(P.med, a.n_med, ro, rd, av, a.t_min, a.t_max, hit, st);
}

// One sample to completion (ops/shade.py trace_paths for one lane);
// returns clamp01(L) and adds the rays it traced to `rays`.
__device__ f3 trace_path(const Args& a, const float* mats, f3 ro, f3 rd, float tm, uint32_t& st,
                         unsigned& rays) {
  const f3 sdir = mk(P.sun[0], P.sun[1], P.sun[2]);
  const f3 srad = mk(P.sun[3], P.sun[4], P.sun[5]);
  const float bias = P.sun[6];
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
    // 1. closest hit; a miss sees the sky
    ++rays;
    Hit h = closest_hit(a, ro, rd, tm, st);
    if (!h.hit) {
      if (a.env >= 0)
        L = add(L, mul(thr, sample_env(a.pool, a.tex_w, a.tex_h, a.tex_off, a.n_textures,
                                       a.pool_n, a.env, a.env_rot, a.env_scale, rd)));
      break;
    }
    const f3 n = h.n;
    const f3 p = mk(ro.x + h.t * rd.x, ro.y + h.t * rd.y, ro.z + h.t * rd.z);
    // medium scatter: isotropic, throughput *= medium albedo
    if (h.med >= 0) {
      const float* m = P.med[h.med];
      thr = mul(thr, mk(m[12], m[13], m[14]));
      ro = p;
      rd = normalize(random_in_unit_sphere(st));
      continue;
    }
    const float* mp = mats + h.mat * 16;
    const int mtype = (int)mp[0];
    // 2. emission
    if (mtype == DIFFUSE_LIGHT) {
      L = add(L, mul(thr, mk(mp[4], mp[5], mp[6])));
      break;
    }
    // 3. albedo
    f3 albedo = mk(mp[1], mp[2], mp[3]);
    if (a.flags & PTEX) albedo = procedural(mp, albedo, p);
    // 4. specular
    if (mtype == METAL) {
      f3 unit_in = normalize(rd);
      f3 refl = reflect(unit_in, n);
      float fuzz = clamp01(mp[7]);
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
      float eta = mp[8];
      if (eta <= 0.0f || !isfinite(eta)) eta = 1.5f;
      float ratio = h.front ? 1.0f / eta : eta;
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
        if (!blocked(a, sh_o, sdir, tm, st)) {
          float pdf_brdf_s = cos_sun / PI_F;
          float w_sun = pdf_brdf_s / (0.5f + 0.5f * pdf_brdf_s);
          L = add(L, scale(mul(mul(thr, albedo), srad), w_sun));
        }
      }
    }
    // 6. next direction: cosine sampling, or the light/BRDF mixture
    if (a.n_lights == 0) {
      float pdf;
      f3 dir = sample_cosine_hemisphere(n, st, pdf);
      if (!(pdf > 0.0f)) break;
      thr = mul(thr, albedo);
      ro = p;
      rd = dir;
      continue;
    }
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
      dir = sphere_light_sample(mk(P.lit[k][0], P.lit[k][1], P.lit[k][2]), P.lit[k][3], p, u1,
                                u2, pdf_lc);
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
  return mk(clamp01(L.x), clamp01(L.y), clamp01(L.z));
}

// Every sample of pixel (x, y) (render.py `_render_lanes` for one lane):
// the jitter pair, the lens disk with an aperture, the shutter time with
// the shutter open, then the path.  Returns the sum of clamp01(L).
__device__ f3 render_pixel(const Args& a, const float* mats, int x, int y, unsigned& rays) {
  uint32_t st = ((uint32_t)x + (uint32_t)y * (uint32_t)a.cam_w) ^ a.seed ^ a.salt;
  const float spp_f = (float)a.spp;
  const float wm1 = (float)(a.cam_w - 1), hm1 = (float)(a.cam_h - 1);
  const float* cam = P.cam;
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
    float tm = 0.0f;
    if (a.flags & SHUTTER) tm = a.time0 + draw(st) * a.dt;
    acc = add(acc, trace_path(a, mats, ro, rd, tm, st, rays));
  }
  return acc;
}

__global__ void __launch_bounds__(BLOCK_W* BLOCK_H) sphere_render_kernel(const Args a) {
  extern __shared__ float mats[];  // n_mats rows of 16
  const int tid = threadIdx.y * BLOCK_W + threadIdx.x;
  for (int i = tid; i < a.n_mats * 16; i += BLOCK_W * BLOCK_H) mats[i] = __ldg(a.mat + i);
  __syncthreads();

  const int x = blockIdx.x * BLOCK_W + threadIdx.x;
  const int y = blockIdx.y * BLOCK_H + threadIdx.y;
  unsigned rays = 0;
  if (x < a.width && y < a.height) {
    const f3 acc = render_pixel(a, mats, x, y, rays);
    float* out = a.accum + ((size_t)y * a.width + x) * 3;
    out[0] = acc.x;
    out[1] = acc.y;
    out[2] = acc.z;
  }
  __shared__ unsigned long long block_rays;
  if (tid == 0) block_rays = 0ull;
  __syncthreads();
  if (rays) atomicAdd(&block_rays, (unsigned long long)rays);
  __syncthreads();
  if (tid == 0) atomicAdd(a.nrays, block_rays);
}

}  // namespace sph
}  // namespace dsrt

extern "C" {

// `params` is the scene's parameter vector (`Params`, its camera slot
// unused), `cam` the camera vector
int dsrt_sphere_render(const float* params, const float* cam, const float* mat,
                       const float* pool, const int* tex_w, const int* tex_h, const int* tex_off,
                       float* accum, unsigned long long* nrays, int width, int height, int cam_w,
                       int cam_h, int spp, int salt, int seed, int max_depth, int rr_start,
                       int n_mats, int n_sph, int n_med, int n_lights, int env, int n_textures,
                       int pool_n, int flags, float rr_max_p, float t_min, float t_max,
                       float env_rot, float env_scale, float time0, float dt, void* stream) {
  using namespace dsrt::sph;
  if (n_sph < 0 || n_sph > MAX_SPH || n_med < 0 || n_med > MAX_MED || n_lights < 0 ||
      n_lights > MAX_LIGHTS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(P, params, sizeof(Params), 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(P, cam, sizeof(Params::cam), offsetof(Params, cam),
                                  cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.mat = mat;
  a.pool = pool;
  a.tex_w = tex_w;
  a.tex_h = tex_h;
  a.tex_off = tex_off;
  a.accum = accum;
  a.nrays = nrays;
  a.width = width;
  a.height = height;
  a.cam_w = cam_w;
  a.cam_h = cam_h;
  a.spp = spp;
  a.salt = (uint32_t)salt;
  a.seed = (uint32_t)seed;
  a.max_depth = max_depth;
  a.rr_start = rr_start;
  a.n_mats = n_mats;
  a.n_sph = n_sph;
  a.n_med = n_med;
  a.n_lights = n_lights;
  a.env = env;
  a.n_textures = n_textures;
  a.pool_n = pool_n;
  a.flags = (unsigned)flags;
  a.rr_max_p = rr_max_p;
  a.t_min = t_min;
  a.t_max = t_max;
  a.env_rot = env_rot;
  a.env_scale = env_scale;
  a.time0 = time0;
  a.dt = dt;
  dim3 block(BLOCK_W, BLOCK_H);
  dim3 grid((width + BLOCK_W - 1) / BLOCK_W, (height + BLOCK_H - 1) / BLOCK_H);
  size_t smem = (size_t)n_mats * 16 * sizeof(float);
  sphere_render_kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// resident blocks per SM of the sphere kernel with n_mats material rows
// in shared memory, or a negative CUDA error code
int dsrt_sphere_occupancy(int n_mats) {
  using namespace dsrt::sph;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, sphere_render_kernel, BLOCK_W * BLOCK_H, (size_t)n_mats * 16 * sizeof(float));
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
