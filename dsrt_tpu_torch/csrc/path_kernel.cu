// The path kernel's instances for scenes without spheres and quads
// (template bit K_PRIMS clear; instance 0 is the flagship's), the C entry
// point `dsrt_path_render`, which picks the instance that matches the
// scene, and `dsrt_path_occupancy`, an instance's resident blocks per SM.
// The kernel itself and its notes are in path_kernel.cuh; the instances
// with spheres and quads are in path_kernel_prims.cu.
//
// Plain PyTorch version: dsrt_tpu_torch/ops/path_kernel.py
// (path_render_plain) over ops/shade.py, ops/trace.py, ops/textures.py.

#include "path_kernel.cuh"

namespace dsrt {
namespace path {

static const KernelFn plain_geometry[8] = {
    path_render_kernel<0>,  path_render_kernel<2>,  path_render_kernel<4>,
    path_render_kernel<6>,  path_render_kernel<8>,  path_render_kernel<10>,
    path_render_kernel<12>, path_render_kernel<14>};

int launch_plain_geometry(unsigned m, const PathArgs& a, const float* params, cudaStream_t s) {
  if ((m & K_PRIMS) || m >= (unsigned)N_INSTANCES) return (int)cudaErrorInvalidValue;
  return launch_instance(plain_geometry[m >> 1], m, a, params, s);
}

KernelFn plain_geometry_kernel(unsigned m) { return plain_geometry[m >> 1]; }

// the instance a scene needs: its template bits from the counts and flags
unsigned required_instance(const PathArgs& a) {
  unsigned m = 0;
  if (a.n_sph > 0 || a.n_quads > 0) m |= K_PRIMS;
  if (a.n_med > 0) m |= K_MEDIA;
  if (a.n_lights > 0) m |= K_LIGHTS;
  if (a.flags & (ENV | PTEX | SMOOTH | APERTURE | SHUTTER | MOVING)) m |= K_EXTRA;
  return m;
}

}  // namespace path
}  // namespace dsrt

extern "C" {

// `counters` is two zeroed 64-bit words: the ray count, then the tile
// counter (its low 32 bits).  `pix` is null for the whole frame, else
// n_pix > 0 flat pixel indices y * width + x, and accum then has n_pix rows
int dsrt_path_render(const float* wide, const float* tri, const float* tri_shade,
                     const float* tri_aux, const float* mat, const float* pool, const int* tex_w,
                     const int* tex_h, const int* tex_off, const float* cam, const float* sun,
                     const float* params, const int* pix, float* accum,
                     unsigned long long* counters, int width, int height, int n_pix, int cam_w,
                     int cam_h, int spp, int salt, int seed, int max_depth,
                     int rr_start, float rr_max_p, float t_min, float t_max, int n_wide,
                     int tri_rows, int n_textures, int pool_n,
                     int n_sph, int n_quads, int n_lights, int n_med, int env, int flags,
                     int instance, float env_rot, float env_scale, float time0, float dt,
                     void* stream) {
  using namespace dsrt::path;
  PathArgs a;
  a.tb = dsrt::WideTables{wide, tri, n_wide, tri_rows};
  a.tri_shade = tri_shade;
  a.tri_aux = tri_aux;
  a.mat = mat;
  a.pool = pool;
  a.tex_w = tex_w;
  a.tex_h = tex_h;
  a.tex_off = tex_off;
  a.cam = cam;
  a.sun = sun;
  a.pix = pix;
  a.accum = accum;
  a.nrays = counters;
  a.next_tile = reinterpret_cast<unsigned*>(counters + 1);
  a.width = width;
  a.height = height;
  a.n_pix = n_pix;
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
  a.n_sph = n_sph;
  a.n_quads = n_quads;
  a.n_lights = n_lights;
  a.n_med = n_med;
  a.env = env;
  a.flags = (unsigned)flags;
  a.env_rot = env_rot;
  a.env_scale = env_scale;
  a.time0 = time0;
  a.dt = dt;
  if (n_sph < 0 || n_sph > MAX_SPH || n_quads < 0 || n_quads > MAX_QUADS || n_lights < 0 ||
      n_lights > MAX_LIGHTS || n_med < 0 || n_med > MAX_MED || (pix && n_pix <= 0) ||
      (unsigned)instance != required_instance(a))
    return (int)cudaErrorInvalidValue;
  const unsigned m = (unsigned)instance;
  cudaStream_t s = (cudaStream_t)stream;
  return (m & K_PRIMS) ? launch_primitives(m, a, params, s)
                       : launch_plain_geometry(m, a, params, s);
}

// resident blocks per SM of kernel instance `instance`, or a negative
// CUDA error code
int dsrt_path_occupancy(int instance) {
  using namespace dsrt::path;
  if (instance < 0 || instance >= N_INSTANCES) return -(int)cudaErrorInvalidValue;
  const unsigned m = (unsigned)instance;
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, (m & K_PRIMS) ? primitives_kernel(m) : plain_geometry_kernel(m), 32 * WARPS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

const char* dsrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
