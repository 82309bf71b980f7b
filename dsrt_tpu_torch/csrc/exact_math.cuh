// A short exact replacement of the double-precision cos and sin on the
// megakernels' bounce chain.  The plain version (dsrt_tpu_torch/ops/
// linalg.py `f64_op`) takes cos and sin in float64 and rounds once to
// float32; the kernels must give the same float, bit for bit.
// libdevice's double cos and sin are built for any argument (a range
// reduction for huge angles, special cases), each call on its own, and
// on the H100 float64 runs at half the float32 rate with a longer
// latency.  The argument here is narrow: the angle of a direction sample,
// phi = TWO_PI_F * u for a draw u = k * 2^-24 (k < 2^24), 2^24 values in
// [0, 2 pi), and both cos and sin of it are needed.
//
// On such a set a short double sequence, accurate to a few double ulps,
// rounds every input to the same float as the correctly rounded value,
// as long as no true value lies that close to a float rounding midpoint.
// That is proven by trying every input, not argued: on the CPU (this
// header built with g++, tests/test_torch_exact_math.py) and on the card
// (`chip_smoke.py`'s exact-math phase, csrc/exact_math_check.cu), each
// against (float)libdevice((double)x) and against `f64_op`.  The
// sequence uses only IEEE double adds and multiplies (no fma: the
// library is built with -fmad=false), so the CPU build and the card
// compute the same doubles.  The polynomials are fdlibm's (k_sin.c,
// k_cos.c), evaluated with the reduced argument's tail.
//
// The other float64 calls stay libdevice's, measured or argued not worth
// replacing (PERF.md, the sphere kernel's redesign): the free path's
// log (a short exact sequence, proven on all 2^24 draws, took more
// registers and made the volumetric frame slower), Schlick's pow (the
// plain version calls libdevice's pow on the card, whose documented
// bound is 2 ulps, so a correctly rounded replacement may differ from it;
// Schlick is 0-1% of the cycles), and the procedural textures' sin
// (arbitrary arguments; the whole procedural phase, Perlin included, is
// 4-5% of the cycles).
#pragma once

#include <cstdint>

namespace dsrt {

// pi / 2 as a 33-bit head (so q * head is exact for q <= 4) and the
// double nearest the rest
constexpr double PIO2_HI = 1.57079632673412561417e+00;
constexpr double PIO2_LO = 6.07710050650619224932e-11;
constexpr double INV_PIO2 = 6.36619772367581382433e-01;

// fdlibm __kernel_sin on [-pi/4, pi/4] with the argument's tail y
__device__ __forceinline__ double kernel_sin(double x, double y) {
  const double S1 = -1.66666666666666324348e-01, S2 = 8.33333333332248946124e-03,
               S3 = -1.98412698298579493134e-04, S4 = 2.75573137070700676789e-06,
               S5 = -2.50507602534068634195e-08, S6 = 1.58969099521155010221e-10;
  double z = x * x;
  double v = z * x;
  double r = S2 + z * (S3 + z * (S4 + z * (S5 + z * S6)));
  return x - ((z * (0.5 * y - v * r) - y) - v * S1);
}

// fdlibm __kernel_cos on [-pi/4, pi/4] with the argument's tail y
__device__ __forceinline__ double kernel_cos(double x, double y) {
  const double C1 = 4.16666666666666019037e-02, C2 = -1.38888888888741095749e-03,
               C3 = 2.48015872894767294178e-05, C4 = -2.75573143513906633035e-07,
               C5 = 2.08757232129817482790e-09, C6 = -1.13596475577881948265e-11;
  double z = x * x;
  double w = z * z;
  double r = z * (C1 + z * (C2 + z * C3)) + w * w * (C4 + z * (C5 + z * C6));
  double hz = 0.5 * z;
  w = 1.0 - hz;
  return w + (((1.0 - w) - hz) + (z * r - x * y));
}

// (float)cos((double)phi) and (float)sin((double)phi) for phi in
// [0, 2 pi), sharing one reduction: q = the nearest quadrant, r = phi - q
// pi/2 as a head and a tail (phi - q * PIO2_HI is exact), then the
// quadrant's signs and swap.  Proven on every phi = TWO_PI_F * k * 2^-24.
__device__ __forceinline__ void sincos_angle(float phi, float& c, float& s) {
  const double x = (double)phi;
  const int q = (int)(x * INV_PIO2 + 0.5);
  const double fq = (double)q;
  const double t = x - fq * PIO2_HI;
  const double w = fq * PIO2_LO;
  const double r = t - w;
  const double y = (t - r) - w;
  const double cr = kernel_cos(r, y);
  const double sr = kernel_sin(r, y);
  const int k = q & 3;
  const double cq = k == 0 ? cr : k == 1 ? -sr : k == 2 ? -cr : sr;
  const double sq = k == 0 ? sr : k == 1 ? cr : k == 2 ? -sr : -cr;
  c = (float)cq;
  s = (float)sq;
}

}  // namespace dsrt
