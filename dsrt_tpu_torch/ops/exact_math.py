"""The exhaustive card check of the kernels' short exact math
(csrc/exact_math.cuh), through the harness csrc/exact_math_check.cu.

For each function the kernels replace, every input they can give it is
tried: cos and sin of TWO_PI_F * u for the 2^24 draws u.  Each result is
held against libdevice's (float)op((double)x) in the harness and against
the plain version's `f64_op` on the same inputs on the card.  The same
set is checked on the CPU by tests/test_torch_exact_math.py.
"""

from __future__ import annotations

import torch

from dsrt_tpu_torch.ops import build
from dsrt_tpu_torch.ops.linalg import f64_op
from dsrt_tpu_torch.ops.path_kernel import _require_cuda

# function -> harness code; each is tried on every draw k * 2^-24
DOMAINS = {"cos": 0, "sin": 1}
N_DRAWS = 1 << 24


def plain(fn: str, x: torch.Tensor) -> torch.Tensor:
    """The plain version's value of `fn` at x (float64, rounded once)."""
    return f64_op(getattr(torch, fn), x)


def check(fn: str, device) -> dict:
    """Every input of `fn` on the card: the count of inputs, and of the
    mismatches (float bits) against libdevice and against `plain`."""
    _require_cuda(torch.device(device))
    lib = build.load()
    x, got, ref = (torch.empty(N_DRAWS, dtype=torch.float32, device=device)
                   for _ in range(3))
    lib_miss = torch.zeros(1, dtype=torch.int64, device=device)
    rc = lib.dsrt_exact_math_check(
        DOMAINS[fn], N_DRAWS, x.data_ptr(), got.data_ptr(), ref.data_ptr(),
        lib_miss.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, rc, "dsrt_exact_math_check")
    want = plain(fn, x)
    return {"inputs": N_DRAWS, "vs_libdevice": int(lib_miss),
            "vs_plain": int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())}
