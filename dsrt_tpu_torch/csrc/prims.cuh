// Device code the two megakernels share: spheres with a moving centre,
// quads, constant media, the primitive shadow tests, the quad-light
// sample and the procedural albedo.  csrc/sphere_kernel.cu and the path
// kernel (csrc/path_kernel.cuh) both include it.
//
// Port of dsrt_tpu/ops/trace.py sphere_pass / quad_pass / media_pass
// (:258-462), dsrt_tpu/ops/shade.py quad_light_from_uniforms (:102-120)
// and dsrt_tpu/ops/textures.py sample_procedural, in the operation order
// of the plain versions (dsrt_tpu_torch/ops/trace.py, shade.py,
// textures.py).  Primitive records are rows of floats:
//   sphere : centre at shutter time 0 (3), radius, material, centre at
//            time 1 (3);
//   quad   : corner q (3), edges u (3), v (3), unit normal n (3),
//            w = (u x v) / |u x v|^2 (3), d = n . q, material, area —
//            n, w, d and area derived in float64 on the host;
//   medium : kind (0 sphere, 1 box), centre (3), radius, box min (3),
//            box max (3), -1/density, albedo (3).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dsrt {

constexpr int PTEX_CHECKER = 1;
constexpr int PTEX_NOISE = 2;
constexpr int PTEX_MARBLE = 3;

// centre of sphere record s at shutter time tm: c0 + tm (c2 - c0)
__device__ __forceinline__ f3 sphere_centre(const float* s, bool moving, float tm) {
  float cx = s[0], cy = s[1], cz = s[2];
  if (moving) {
    cx = cx + tm * (s[5] - cx);
    cy = cy + tm * (s[6] - cy);
    cz = cz + tm * (s[7] - cz);
  }
  return mk(cx, cy, cz);
}

// sphere s along the ray (av = d . d): the accepted root in
// [t_min, closest], if any, and the centre it was taken at
__device__ __forceinline__ bool sphere_root(const float* s, bool moving, f3 ro, f3 rd, float av,
                                            float tm, float t_min, float closest, float& root,
                                            f3& c) {
  c = sphere_centre(s, moving, tm);
  float r = s[3];
  f3 oc = sub(ro, c);
  float half_b = dot(oc, rd);
  float cq = dot(oc, oc) - r * r;
  float disc = half_b * half_b - av * cq;
  float sq = sqrtf(nmax(disc, 0.0f));
  float root1 = (-half_b - sq) / av;
  float root2 = (-half_b + sq) / av;
  bool r1ok = root1 >= t_min && root1 <= closest;
  root = r1ok ? root1 : root2;
  return disc >= 0.0f && root >= t_min && root <= closest;
}

// face-flipped outward normal of sphere s at ray parameter root
__device__ __forceinline__ f3 sphere_normal(const float* s, f3 ro, f3 rd, float root, f3 c,
                                            bool& front) {
  float r = s[3];
  float inv_r = 1.0f / (r != 0.0f ? r : 1.0f);
  f3 nv = mk((ro.x + root * rd.x - c.x) * inv_r, (ro.y + root * rd.y - c.y) * inv_r,
             (ro.z + root * rd.z - c.z) * inv_r);
  front = (rd.x * nv.x + rd.y * nv.y + rd.z * nv.z) < 0.0f;
  return scale(nv, front ? 1.0f : -1.0f);
}

// quad q along the ray: the plane hit t in [t_min, closest] with both
// coordinates alpha = w . (p x v), beta = w . (u x p) in [0, 1];
// front = the ray meets the side n points to
__device__ __forceinline__ bool quad_hit(const float* q, f3 ro, f3 rd, float t_min, float closest,
                                         float& t, bool& front) {
  float denom = rd.x * q[9] + rd.y * q[10] + rd.z * q[11];
  bool ok = fabsf(denom) >= 1e-8f;
  t = (q[15] - (ro.x * q[9] + ro.y * q[10] + ro.z * q[11])) / (ok ? denom : 1.0f);
  ok = ok && t >= t_min && t <= closest;
  float px = ro.x + t * rd.x - q[0];
  float py = ro.y + t * rd.y - q[1];
  float pz = ro.z + t * rd.z - q[2];
  float cx = py * q[8] - pz * q[7];
  float cy = pz * q[6] - px * q[8];
  float cz = px * q[7] - py * q[6];
  float alpha = q[12] * cx + q[13] * cy + q[14] * cz;
  cx = q[4] * pz - q[5] * py;
  cy = q[5] * px - q[3] * pz;
  cz = q[3] * py - q[4] * px;
  float beta = q[12] * cx + q[13] * cy + q[14] * cz;
  front = denom < 0.0f;
  return ok && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
}

// medium m along the ray: enters its boundary interval (clipped to
// [t_min, closest]) and the free path from draw u ends inside it
__device__ __forceinline__ bool medium_hit(const float* m, f3 ro, f3 rd, float av, float rlen,
                                           float t_min, float closest, float u, float& t) {
  f3 oc = mk(ro.x - m[1], ro.y - m[2], ro.z - m[3]);
  float half_b = dot(oc, rd);
  float cq = dot(oc, oc) - m[4] * m[4];
  float disc = half_b * half_b - av * cq;
  float sq = sqrtf(nmax(disc, 0.0f));
  bool has;
  float t0, t1;
  if (m[0] == 0.0f) {  // sphere boundary: both roots
    has = disc > 0.0f;
    t0 = (-half_b - sq) / av;
    t1 = (-half_b + sq) / av;
  } else {  // box boundary: slab interval
    const float o[3] = {ro.x, ro.y, ro.z};
    const float d[3] = {rd.x, rd.y, rd.z};
    t0 = -0x1.c363ccp+127f;  // -3e38
    t1 = 0x1.c363ccp+127f;
    for (int ax = 0; ax < 3; ++ax) {
      float inv = 1.0f / d[ax];
      float ta = (m[5 + ax] - o[ax]) * inv;
      float tb = (m[8 + ax] - o[ax]) * inv;
      t0 = nmax(t0, nmin(ta, tb));
      t1 = nmin(t1, nmax(ta, tb));
    }
    has = t1 > t0;
  }
  float e0 = nmax(t0, t_min);
  float e1 = nmin(t1, closest);
  float dist_inside = (e1 - e0) * rlen;
  float hit_dist = m[11] * (float)log((double)nmax(u, 0x1.4484c0p-100f));
  t = e0 + hit_dist / nmax(rlen, 0x1.4484c0p-100f);
  return has && e0 < e1 && hit_dist <= dist_inside;
}

// shadow query over spheres: any root in [t_min, t_max]
__device__ __forceinline__ bool spheres_block(const float (*sph)[8], int n, bool moving, f3 ro,
                                              f3 rd, float av, float tm, float t_min,
                                              float t_max) {
  bool hit = false;
  for (int i = 0; i < n && !hit; ++i) {
    float root;
    f3 c;
    hit = sphere_root(sph[i], moving, ro, rd, av, tm, t_min, t_max, root, c);
  }
  return hit;
}

// shadow query over quads
__device__ __forceinline__ bool quads_block(const float (*quad)[18], int n, f3 ro, f3 rd,
                                            float t_min, float t_max) {
  bool hit = false;
  for (int j = 0; j < n && !hit; ++j) {
    float t;
    bool front;
    hit = quad_hit(quad[j], ro, rd, t_min, t_max, t, front);
  }
  return hit;
}

// shadow query over media, after the surfaces (`hit`): every medium
// draws once, blocked or not
__device__ __forceinline__ bool media_block(const float (*med)[15], int n, f3 ro, f3 rd, float av,
                                            float t_min, float t_max, bool hit, uint32_t& st) {
  if (n > 0) {
    const float rlen = sqrtf(av);
    for (int i = 0; i < n; ++i) {
      float u = draw(st);
      float t;
      if (!hit) hit = medium_hit(med[i], ro, rd, av, rlen, t_min, t_max, u, t);
    }
  }
  return hit;
}

// uniform point on quad light q (record layout above) from two uniforms:
// the direction from `origin` and its solid-angle pdf
// dist^2 / (|cos| area), 0 within 1e-3 of the point or at |cos| <= 1e-8
__device__ __forceinline__ f3 quad_light_sample(const float* q, float area, f3 origin, float u1,
                                                float u2, float& pdf) {
  f3 pl = mk(q[0] + u1 * q[3] + u2 * q[6], q[1] + u1 * q[4] + u2 * q[7],
             q[2] + u1 * q[5] + u2 * q[8]);
  f3 tl = sub(pl, origin);
  float dist2 = dot(tl, tl);
  float dist = sqrtf(dist2);
  bool ok = dist > 1e-3f;
  f3 wi = ok ? scale(tl, 1.0f / dist) : mk(0.0f, 0.0f, 1.0f);
  float cos_l = fabsf(wi.x * q[9] + wi.y * q[10] + wi.z * q[11]);
  ok = ok && cos_l > 1e-8f && area > 0.0f;
  pdf = ok ? dist2 / (cos_l * area) : 0.0f;
  return wi;
}

// albedo of a checker / marble / noise material row mp at p
__device__ inline f3 procedural(const float* mp, f3 base, f3 p) {
  int kind = (int)mp[9];
  float sc = mp[10];
  if (kind == PTEX_CHECKER) {
    float sines = (float)sin((double)(sc * p.x)) * (float)sin((double)(sc * p.y)) *
                  (float)sin((double)(sc * p.z));
    return sines < 0.0f ? mk(mp[11], mp[12], mp[13]) : base;
  }
  if (kind == PTEX_MARBLE) {
    float turb = perlin_turb(p);
    float m = 0.5f * (1.0f + (float)sin((double)(sc * p.z + 10.0f * turb)));
    return mk(m, m, m);
  }
  if (kind == PTEX_NOISE) {
    float nv = clamp01(perlin_turb(p));
    return mk(nv, nv, nv);
  }
  return base;
}

}  // namespace dsrt
