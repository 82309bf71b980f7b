// Device helpers shared by the kernels: the per-pixel LCG, 3-vector math
// in the reference's operation order, NaN-propagating min/max, the
// samplers (unit ball, unit disk, cosine hemisphere, sphere light), the
// texture fetch with the equirect sky, and the hash-gradient Perlin.
//
// Port of dsrt_tpu/ops/rng.py, dsrt_tpu/ops/linalg.py, the samplers of
// dsrt_tpu/ops/shade.py and dsrt_tpu/ops/camera.py, and
// dsrt_tpu/ops/textures.py.  The library is
// built with -fmad=false and without fast-math, so every expression below
// rounds exactly like the plain PyTorch version (dsrt_tpu_torch/ops/).
// cos, sin and pow are evaluated in double and rounded once to float, as
// the plain version does, so both give the correctly rounded float;
// sqrtf and '/' are IEEE-exact already.  Float constants that are not
// short binary fractions are written as hex literals of the float32
// values the reference uses.
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

// cosine-weighted world direction about n and its pdf; 2 draws
__device__ __forceinline__ f3 sample_cosine_hemisphere(f3 n, uint32_t& s, float& pdf) {
  f3 local = random_cosine_direction(s);
  f3 wv = normalize(n);
  bool big = fabsf(wv.x) > 0.9f;
  f3 av = mk(big ? 0.0f : 1.0f, big ? 1.0f : 0.0f, 0.0f);
  f3 vv = normalize(cross(wv, av));
  f3 uv = cross(vv, wv);
  f3 world = normalize(add(add(scale(uv, local.x), scale(vv, local.y)), scale(wv, local.z)));
  float cos_o = nmax(dot(world, n), 0.0f);
  pdf = cos_o > 0.0f ? cos_o / PI_F : 0.0f;
  return world;
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

// rejection sample of the unit disk (thin lens): one attempt of 2 draws,
// then up to 64 retries
__device__ __forceinline__ void random_in_unit_disk(uint32_t& s, float& x, float& y) {
  for (int i = 0; i <= 64; ++i) {
    x = draw(s) * 2.0f - 1.0f;
    y = draw(s) * 2.0f - 1.0f;
    if (x * x + y * y < 1.0f) break;
  }
}

// uniform point on a sphere light from two uniforms: the direction from
// `origin` (normalised by a reciprocal multiply) and its solid-angle pdf
// dist^2 / (cos_light * 4 pi r^2), 0 when the point faces away
__device__ __forceinline__ f3 sphere_light_sample(f3 c, float radius, f3 origin, float uz,
                                                  float uphi, float& pdf) {
  float z = 2.0f * uz - 1.0f;
  float phi = TWO_PI_F * uphi;
  float r = sqrtf(nmax(1.0f - z * z, 0.0f));
  f3 local = mk(r * (float)cos((double)phi), r * (float)sin((double)phi), z);
  f3 pl = add(c, scale(local, radius));
  f3 tl = sub(pl, origin);
  float dist2 = dot(tl, tl);
  float dist = sqrtf(dist2);
  bool ok = dist > 0.0f;
  f3 wi = ok ? scale(tl, 1.0f / dist) : mk(0.0f, 0.0f, 1.0f);
  f3 nl = normalize(sub(pl, c));
  float cos_l = nmax(dot(nl, neg(wi)), 0.0f);
  ok = ok && cos_l > 0.0f;
  float area = 4.0f * PI_F * radius * radius;
  pdf = ok ? dist2 / (cos_l * area) : 0.0f;
  return wi;
}

// nearest-neighbour texel: floor-frac wrap, V-flip, white when invalid
__device__ __forceinline__ f3 sample_texel(const float* pool, const int* tex_w, const int* tex_h,
                                           const int* tex_off, int n_textures, int pool_n,
                                           int tex, float u, float v) {
  bool valid = tex >= 0 && tex < n_textures;
  int tid = min(max(tex, 0), max(n_textures - 1, 0));
  int w = __ldg(tex_w + tid), h = __ldg(tex_h + tid), off = __ldg(tex_off + tid);
  float uu = u - floorf(u);
  float vv = v - floorf(v);
  int i = (int)(uu * (float)(w - 1));
  int j = (int)((1.0f - vv) * (float)(h - 1));
  int idx = off + (j * w + i) * 3;
  if (!(valid && idx >= 0 && idx + 2 < pool_n)) return mk(1.0f, 1.0f, 1.0f);
  return mk(__ldg(pool + idx), __ldg(pool + idx + 1), __ldg(pool + idx + 2));
}

// atan2 from an odd minimax polynomial of atan on [0, 1] (|err| < 3e-7)
// and a quadrant fix-up: the reference's own, not the library's
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float mx = nmax(ax, ay), mn = nmin(ax, ay);
  float t = mn / nmax(mx, 0x1.4484c0p-100f);  // 1e-30
  float s = t * t;
  float p = 0x1.fffd04p-1f +
            s * (-0x1.549b40p-2f +
                 s * (0x1.8c6084p-3f + s * (-0x1.dce8b6p-4f +
                                            s * (0x1.af5604p-5f + s * -0x1.80148ep-7f))));
  p = t * p;
  float r = ay > ax ? 0x1.921fb6p+0f - p : p;  // pi / 2
  r = x < 0.0f ? PI_F - r : r;
  return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float acos_poly(float x) {
  return atan2_poly(sqrtf(nmax(1.0f - x * x, 0.0f)), x);
}

// equirect sky radiance along a (not necessarily unit) direction:
// u = atan2(z, x) / 2pi + 0.5 + rot, v = 1 - acos(y) / pi, then the texel
__device__ __forceinline__ f3 sample_env(const float* pool, const int* tex_w, const int* tex_h,
                                         const int* tex_off, int n_textures, int pool_n,
                                         int env, float rot, float env_scale, f3 d) {
  float inv_len = 1.0f / sqrtf(nmax(d.x * d.x + d.y * d.y + d.z * d.z, 0x1.79ca10p-67f));
  float u = atan2_poly(d.z * inv_len, d.x * inv_len) / TWO_PI_F + 0.5f + rot;
  float v = 1.0f - acos_poly(nmin(nmax(d.y * inv_len, -1.0f), 1.0f)) / PI_F;
  v = nmin(nmax(v, 0.0f), 0x1.ffffdep-1f);  // 1 - 1e-6: the poles never wrap
  f3 rgb = sample_texel(pool, tex_w, tex_h, tex_off, n_textures, pool_n, env, u, v);
  return scale(rgb, env_scale);
}

// ---- hash-gradient Perlin ------------------------------------------------
__device__ __forceinline__ uint32_t hash3(int i, int j, int k) {
  uint32_t h = ((uint32_t)i * 0x9E3779B1u) ^ ((uint32_t)j * 0x85EBCA77u) ^
               ((uint32_t)k * 0xC2B2AE3Du);
  h ^= h >> 13;
  h *= 0x27D4EB2Fu;
  h ^= h >> 16;
  return h;
}

// one of improved noise's 12 edge gradients, picked by 4 hash bits
__device__ __forceinline__ float grad_dot(uint32_t h, float x, float y, float z) {
  int hh = (int)(h & 15u);
  float u = hh < 8 ? x : y;
  float v = hh < 4 ? y : ((hh == 12 || hh == 14) ? x : z);
  return ((hh & 1) == 0 ? u : -u) + ((hh & 2) == 0 ? v : -v);
}

__device__ inline float perlin_noise(float px, float py, float pz) {
  float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  float u = px - fx, v = py - fy, w = pz - fz;
  int i = (int)fx, j = (int)fy, k = (int)fz;
  float uu = u * u * (3.0f - 2.0f * u);
  float vv = v * v * (3.0f - 2.0f * v);
  float ww = w * w * (3.0f - 2.0f * w);
  float accum = 0.0f;
  for (int di = 0; di < 2; ++di)
    for (int dj = 0; dj < 2; ++dj)
      for (int dk = 0; dk < 2; ++dk) {
        uint32_t h = hash3(i + di, j + dj, k + dk);
        float dotv = grad_dot(h, u - (float)di, v - (float)dj, w - (float)dk);
        float wt = (di ? uu : 1.0f - uu) * (dj ? vv : 1.0f - vv) * (dk ? ww : 1.0f - ww);
        accum = accum + wt * dotv;
      }
  return accum * 0.5f;
}

// |fbm| over 7 octaves
__device__ inline float perlin_turb(f3 p) {
  float accum = 0.0f, weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    accum = accum + weight * perlin_noise(p.x, p.y, p.z);
    weight *= 0.5f;
    p = scale(p, 2.0f);
  }
  return fabsf(accum);
}

}  // namespace dsrt
