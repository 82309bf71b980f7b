"""The kernels' short exact cos and sin (csrc/exact_math.cuh), built with
g++ on the CPU against a stub of the CUDA qualifiers.

The header uses IEEE double adds and multiplies only, and the library and
this build both keep every a*b+c as two roundings (-fmad=false,
-ffp-contract=off), so the CPU computes the card's doubles.  Every input
the kernels give the function is tried (the card's exact-math phase in
`chip_smoke.py` tries them all again there): cos and sin of TWO_PI_F * u
for all 2^24 draws u = k * 2^-24, equal (tolerance: none) to numpy's
float64 value rounded to float32 and to the port's `f64_op`.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dsrt_tpu_torch.ops.linalg import f64_op

CSRC = Path(__file__).resolve().parents[1] / "dsrt_tpu_torch" / "csrc"
N_DRAWS = 1 << 24
TWO_PI_F = np.float32(2.0) * np.float32(np.pi)

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
"""

DRIVER = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include "common.cuh"
using namespace dsrt;

// phi, cos, sin for every draw k * 2^-24
int main(int argc, char** argv) {
  FILE* out = fopen(argv[1], "wb");
  for (uint32_t k = 0; k < (1u << 24); ++k) {
    float u = (float)k * (1.0f / 16777216.0f);
    float phi = TWO_PI_F * u;
    float c, s;
    sincos_angle(phi, c, s);
    float row[3] = {phi, c, s};
    fwrite(row, 4, 3, out);
  }
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def draws(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact_math")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "driver.cpp").write_text(DRIVER)
    exe = d / "driver"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-I", str(d), "-I", str(CSRC),
                    "-o", str(exe), str(d / "driver.cpp")], check=True,
                   capture_output=True, text=True)
    out = d / "draws.bin"
    subprocess.run([str(exe), str(out)], check=True)
    return np.fromfile(out, np.float32).reshape(-1, 3)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("fn", ["cos", "sin"])
def test_draw_angles_are_exact_on_every_draw(draws, fn):
    phi = TWO_PI_F * (np.arange(N_DRAWS, dtype=np.float32)
                      * np.float32(2.0 ** -24))
    assert np.array_equal(_bits(draws[:, 0]), _bits(phi))
    got = draws[:, {"cos": 1, "sin": 2}[fn]]
    want_np = getattr(np, fn)(phi.astype(np.float64)).astype(np.float32)
    want_port = f64_op(getattr(torch, fn), torch.from_numpy(phi)).numpy()
    assert np.count_nonzero(_bits(got) != _bits(want_np)) == 0
    assert np.count_nonzero(_bits(got) != _bits(want_port)) == 0
