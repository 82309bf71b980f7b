// The path-tracing megakernel for Hopper (sm_90a), and a closest-hit
// kernel over the same walk.
//
// Replaces dsrt_tpu/ops/pallas_path.py `_path_kernel` (launched by
// `_run_path`) for its triangle scope: triangle meshes, flat normals,
// lambertian / metal / dielectric / diffuse_light materials, image
// textures, the directional sun with MIS, pinhole camera, no shutter.
// It computes what that kernel computes, in the shape of the CUDA
// reference renderer: ONE THREAD PER PIXEL runs every sample and every
// bounce, with per-thread control flow and the per-pixel LCG stream
// (x + y*W) ^ seed ^ salt drawn exactly as the scalar loop draws it.  The
// TPU kernel's lockstep lanes, sample regeneration, scalar stacks and
// one-hot gathers do not carry over.
//
// What bounds it on the H100: the tree walk is a chain of dependent
// global loads (node row -> thread-table entry -> next node row), so a
// thread is latency-bound, and neighbouring pixels diverge in depth,
// material and walk length, so warps run partly idle.  This first version
// takes the simplest correct form: 16x8-pixel blocks for some ray
// coherence, read-only (__ldg) 16-byte loads of 64-byte table rows, the
// binary octant-ordered walk of the plain version (the 8-ary wide-BVH
// walk is later work), and one 64-bit atomic per block for the ray count.
//
// Plain PyTorch version: dsrt_tpu_torch/ops/path_kernel.py
// (path_render_plain) over ops/shade.py and ops/trace.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "walk.cuh"

namespace dsrt {

constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int DIELECTRIC = 2;
constexpr int DIFFUSE_LIGHT = 3;

constexpr int BLOCK_W = 16;
constexpr int BLOCK_H = 8;

struct PathArgs {
  Tables tb;
  const float* tri_shade;
  const float* mat;
  const float* pool;
  const int* tex_w;
  const int* tex_h;
  const int* tex_off;
  const float* cam;  // origin, lower_left, horizontal, vertical
  const float* sun;  // Ldir (3), radiance (3), shadow bias
  float* accum;      // [height][width][3]
  unsigned long long* nrays;
  int width, height;      // pixel grid
  int cam_w, cam_h;       // camera raster (seeding and raygen)
  int spp;
  uint32_t salt, seed;
  int max_depth, rr_start;
  float rr_max_p, t_min, t_max;
  int n_textures, pool_n;
  bool sun_on, textured;
};

__device__ __forceinline__ f3 sample_image(const PathArgs& a, int tex, float u, float v) {
  return sample_texel(a.pool, a.tex_w, a.tex_h, a.tex_off, a.n_textures, a.pool_n, tex, u, v);
}

// One sample to completion (ops/shade.py trace_paths for one lane);
// returns clamp01(L) and adds the rays it traced to `rays`.
__device__ f3 trace_path(const PathArgs& a, f3 ro, f3 rd, uint32_t& st, unsigned& rays) {
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
    // 1. closest hit; a miss sees the black background
    ++rays;
    WalkHit w = walk<false>(a.tb, ro, rd, a.t_min, a.t_max);
    if (w.tri < 0) break;
    SurfaceHit s = assemble(a.tri_shade, w, rd);
    f3 n = s.n;
    f3 p = mk(ro.x + w.t * rd.x, ro.y + w.t * rd.y, ro.z + w.t * rd.z);
    const float* mp = a.mat + (size_t)s.mat * 16;
    int mtype = (int)__ldg(mp);
    // 2. emission
    if (mtype == DIFFUSE_LIGHT) {
      L = add(L, mul(thr, mk(__ldg(mp + 4), __ldg(mp + 5), __ldg(mp + 6))));
      break;
    }
    // 3. albedo
    f3 albedo = mk(__ldg(mp + 1), __ldg(mp + 2), __ldg(mp + 3));
    if (a.textured && s.tex >= 0) albedo = mul(albedo, sample_image(a, s.tex, s.tu, s.tv));
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
      float ratio = s.front ? 1.0f / eta : eta;
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
    // 5. sun MIS with a shadow ray from p + bias * n
    if (a.sun_on) {
      float cos_sun = nmax(dot(n, sdir), 0.0f);
      if (cos_sun > 0.0f) {
        ++rays;
        f3 sh_o = mk(p.x + bias * n.x, p.y + bias * n.y, p.z + bias * n.z);
        WalkHit sh = walk<true>(a.tb, sh_o, sdir, a.t_min, a.t_max);
        if (sh.tri < 0) {
          float pdf_brdf_s = cos_sun / PI_F;
          float w_sun = pdf_brdf_s / (0.5f + 0.5f * pdf_brdf_s);
          L = add(L, scale(mul(mul(thr, albedo), srad), w_sun));
        }
      }
    }
    // 6-7. cosine-hemisphere continuation; throughput *= albedo
    float pdf;
    f3 world = sample_cosine_hemisphere(n, st, pdf);
    if (!(pdf > 0.0f)) break;
    thr = mul(thr, albedo);
    ro = p;
    rd = world;
  }
  return mk(clamp01(L.x), clamp01(L.y), clamp01(L.z));
}

__global__ void __launch_bounds__(BLOCK_W* BLOCK_H)
    path_render_kernel(const PathArgs a) {
  const int x = blockIdx.x * BLOCK_W + threadIdx.x;
  const int y = blockIdx.y * BLOCK_H + threadIdx.y;
  unsigned rays = 0;
  if (x < a.width && y < a.height) {
    uint32_t st = ((uint32_t)x + (uint32_t)y * (uint32_t)a.cam_w) ^ a.seed ^ a.salt;
    const f3 org = mk(a.cam[0], a.cam[1], a.cam[2]);
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
      f3 rd = mk(a.cam[3] + u * a.cam[6] + v * a.cam[9] - a.cam[0],
                 a.cam[4] + u * a.cam[7] + v * a.cam[10] - a.cam[1],
                 a.cam[5] + u * a.cam[8] + v * a.cam[11] - a.cam[2]);
      acc = add(acc, trace_path(a, org, rd, st, rays));
    }
    float* out = a.accum + ((size_t)y * a.width + x) * 3;
    out[0] = acc.x;
    out[1] = acc.y;
    out[2] = acc.z;
  }
  __shared__ unsigned long long block_rays;
  if (threadIdx.x == 0 && threadIdx.y == 0) block_rays = 0ull;
  __syncthreads();
  if (rays) atomicAdd(&block_rays, (unsigned long long)rays);
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) atomicAdd(a.nrays, block_rays);
}

__global__ void __launch_bounds__(256)
    closest_hit_kernel(Tables tb, const float* ro, const float* rd, float* t_out,
                       float* u_out, float* v_out, int* tri_out, int n, float t_min,
                       float t_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  f3 o = mk(ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]);
  f3 d = mk(rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]);
  WalkHit h = walk<false>(tb, o, d, t_min, t_max);
  t_out[i] = h.t;
  u_out[i] = h.u;
  v_out[i] = h.v;
  tri_out[i] = h.tri;
}

}  // namespace dsrt

extern "C" {

int dsrt_path_render(const float* bvh, const float* thr, const float* tri,
                     const float* tri_shade, const float* mat, const float* pool,
                     const int* tex_w, const int* tex_h, const int* tex_off,
                     const float* cam, const float* sun, float* accum,
                     unsigned long long* nrays, int width, int height, int cam_w,
                     int cam_h, int spp, int salt, int seed, int max_depth, int rr_start,
                     float rr_max_p, float t_min, float t_max, int end, int tri_rows,
                     int n_textures, int pool_n, int sun_on, int textured, void* stream) {
  dsrt::PathArgs a;
  a.tb = dsrt::Tables{bvh, thr, tri, end, tri_rows};
  a.tri_shade = tri_shade;
  a.mat = mat;
  a.pool = pool;
  a.tex_w = tex_w;
  a.tex_h = tex_h;
  a.tex_off = tex_off;
  a.cam = cam;
  a.sun = sun;
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
  a.rr_max_p = rr_max_p;
  a.t_min = t_min;
  a.t_max = t_max;
  a.n_textures = n_textures;
  a.pool_n = pool_n;
  a.sun_on = sun_on != 0;
  a.textured = textured != 0;
  dim3 block(dsrt::BLOCK_W, dsrt::BLOCK_H);
  dim3 grid((width + dsrt::BLOCK_W - 1) / dsrt::BLOCK_W,
            (height + dsrt::BLOCK_H - 1) / dsrt::BLOCK_H);
  dsrt::path_render_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int dsrt_closest_hit(const float* bvh, const float* thr, const float* tri,
                     const float* ro, const float* rd, float* t_out, float* u_out,
                     float* v_out, int* tri_out, int n, int end, int tri_rows,
                     float t_min, float t_max, void* stream) {
  dsrt::Tables tb{bvh, thr, tri, end, tri_rows};
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    dsrt::closest_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        tb, ro, rd, t_out, u_out, v_out, tri_out, n, t_min, t_max);
  return (int)cudaGetLastError();
}

const char* dsrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
