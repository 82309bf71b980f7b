// The exhaustive check of csrc/exact_math.cuh on the card: for every
// input of a function's domain, the short sequence's float beside
// libdevice's (float)op((double)x), and a count of the inputs where they
// differ.  The inputs are written out too, so that the caller
// (dsrt_tpu_torch/ops/exact_math.py) holds the same floats against the
// plain version's `f64_op` on the card.  A harness for the proof, not a
// kernel of the render path.
//
// Domains (`fn`), input i being the draw u = i * 2^-24: 0, 1: cos, sin
// of phi = TWO_PI_F * u.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "exact_math.cuh"

namespace dsrt {

__global__ void exact_math_check_kernel(int fn, int n, float* in, float* got, float* lib,
                                        unsigned long long* mismatches) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float u = (float)((uint32_t)i & 0x00FFFFFFu) * (1.0f / 16777216.0f);
  const float x = TWO_PI_F * u;
  float c, s;
  sincos_angle(x, c, s);
  const float g = fn == 0 ? c : s;
  const float l = fn == 0 ? (float)cos((double)x) : (float)sin((double)x);
  in[i] = x;
  got[i] = g;
  lib[i] = l;
  if (__float_as_uint(g) != __float_as_uint(l)) atomicAdd(mismatches, 1ull);
}

}  // namespace dsrt

extern "C" int dsrt_exact_math_check(int fn, int n, float* in, float* got, float* lib,
                                     unsigned long long* mismatches, void* stream) {
  if (fn < 0 || fn > 1 || n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dsrt::exact_math_check_kernel<<<(n + threads - 1) / threads, threads, 0,
                                  (cudaStream_t)stream>>>(fn, n, in, got, lib, mismatches);
  return (int)cudaGetLastError();
}
