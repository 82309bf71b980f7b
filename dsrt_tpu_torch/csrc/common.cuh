// Device helpers shared by the kernels: the per-pixel LCG, 3-vector math
// in the reference's operation order, and NaN-propagating min/max.
//
// Port of dsrt_tpu/ops/rng.py and dsrt_tpu/ops/linalg.py.  The library is
// built with -fmad=false and without fast-math, so every expression below
// rounds exactly like the plain PyTorch version (dsrt_tpu_torch/ops/).
// cos, sin and pow are evaluated in double and rounded once to float, as
// the plain version does, so both give the correctly rounded float;
// sqrtf and '/' are IEEE-exact already.
#pragma once

#include <cstdint>
#include <math.h>

namespace dsrt {

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ f3 add(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 sub(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 mul(f3 a, f3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ f3 scale(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 neg(f3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ f3 cross(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.maximum / torch.minimum (and jnp.maximum / jnp.minimum) return NaN
// when either side is NaN; fmaxf / fminf would drop it.
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clamp01(float a) { return nmin(nmax(a, 0.0f), 1.0f); }

// zero vector -> zero; reciprocal-multiply like the reference's normalize
__device__ __forceinline__ f3 normalize(f3 a) {
  float l2 = dot(a, a);
  float inv = l2 > 0.0f ? 1.0f / sqrtf(nmax(l2, 1e-38f)) : 0.0f;
  return scale(a, inv);
}

__device__ __forceinline__ f3 reflect(f3 v, f3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }

__device__ __forceinline__ f3 refract(f3 uv, f3 n, float eta) {
  float cos_theta = nmin(dot(neg(uv), n), 1.0f);
  f3 r_perp = scale(add(uv, scale(n, cos_theta)), eta);
  f3 r_par = scale(n, -sqrtf(fabsf(1.0f - dot(r_perp, r_perp))));
  return add(r_perp, r_par);
}

__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * (float)pow((double)(1.0f - cosine), 5.0);
}

// ---- LCG: state = state * 1664525 + 1013904223 (mod 2^32) ---------------
__device__ __forceinline__ float draw(uint32_t& s) {
  s = s * 1664525u + 1013904223u;
  return (float)(s & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 2.0f * PI_F;  // exact doubling of the f32 pi

// cosine-weighted local (z-up) direction; 2 draws
__device__ __forceinline__ f3 random_cosine_direction(uint32_t& s) {
  float r1 = draw(s);
  float r2 = draw(s);
  float z = sqrtf(nmax(1.0f - r2, 0.0f));
  float phi = TWO_PI_F * r1;
  float sq = sqrtf(nmax(r2, 0.0f));
  return {(float)cos((double)phi) * sq, (float)sin((double)phi) * sq, z};
}

// rejection sample of the unit ball: one attempt, then up to 64 retries
__device__ __forceinline__ f3 random_in_unit_sphere(uint32_t& s) {
  f3 p;
  for (int i = 0; i <= 64; ++i) {
    float x = draw(s);
    float y = draw(s);
    float z = draw(s);
    p = mk(x * 2.0f - 1.0f, y * 2.0f - 1.0f, z * 2.0f - 1.0f);
    if (!(p.x * p.x + p.y * p.y + p.z * p.z >= 1.0f)) break;
  }
  return p;
}

}  // namespace dsrt
