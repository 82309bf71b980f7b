"""ctypes bridge to the native C++ BVH builder (csrc/bvh_builder.cpp).

A copy of dsrt_tpu/native.py, except that the port builds its own copy of
the builder instead of loading a committed library: at first use, g++
compiles csrc/bvh_builder.cpp with the JAX package's Makefile flags,
with -mfma in place of -march=native,

    g++ -O3 -mfma -fPIC -std=c++17 -Wall -Wextra -shared

into <repo>/build/dsrt_tpu_torch/, named by a hash of the source and the
flags.  In C++ GCC contracts a*b+c into FMAs whenever the target has them
(-ffp-contract=fast, whatever the -std), and the JAX package's library
was built with -march=native on an FMA host; -mfma makes the same
contractions without tying the library to the build host's full
instruction set, so the SBVH and the tables are bit-identical to the JAX
package's (without it they are not).  Each process compiles to
a pid-tagged file and renames it into place, so parallel test workers do
not race.  Without g++ everything degrades to the NumPy builders, as the
JAX package does without its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "dsrt_tpu_torch"
CXX_FLAGS = ["-O3", "-mfma", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-shared"]

_LIB = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdsrt_native_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    """Build the library into `out`; False when there is no g++, raise
    when the compiler fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx] + CXX_FLAGS + ["-o", str(tmp),
                                                   str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    out = library_path()
    if not out.exists() and not _compile(out):
        return None
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LIB = lib
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dsrt_build_bvh.restype = ctypes.c_int
    lib.dsrt_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int,          # v0, v1, v2, n
        ctypes.c_int,                             # method: 0 median, 1 sah
        f32p, f32p,                               # out bbox_min/max (2N,3)
        i32p, i32p, i32p, i32p,                   # out left/right/off/cnt
        i32p,                                     # out tri_indices (n)
    ]
    lib.dsrt_build_sbvh.restype = ctypes.c_int
    lib.dsrt_build_sbvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int,           # v0, v1, v2, n
        ctypes.c_float, ctypes.c_float,           # alpha, ref_budget
        ctypes.c_int, ctypes.c_int,               # cap_nodes, cap_refs
        f32p, f32p,                               # out bbox_min/max
        i32p, i32p, i32p, i32p,                   # out left/right/off/cnt
        i32p,                                     # out ref list
        np.ctypeslib.ndpointer(np.int32),         # out n_refs (1,)
    ]


def available() -> bool:
    return _find_lib() is not None


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              method: str = "median", alpha: float = 1e-5,
              ref_budget: float = 2.0):
    """Native BVH build; returns a models.bvh_build.BVH or None if the
    native library is unavailable.  `alpha` / `ref_budget` tune the
    SBVH spatial-split gate (overlap-area fraction of root SA that
    triggers a spatial-split attempt) and the reference cap
    (budget * n) — ignored for median/sah."""
    lib = _find_lib()
    if lib is None:
        return None
    from dsrt_tpu_torch.models.bvh_build import BVH

    n = len(v0)
    if method == "sbvh":
        budget = float(ref_budget)
        cap_refs = int(budget * n) + 8
        cap_nodes = 2 * cap_refs + 8
        bb_min = np.empty((cap_nodes, 3), np.float32)
        bb_max = np.empty((cap_nodes, 3), np.float32)
        left = np.empty(cap_nodes, np.int32)
        right = np.empty(cap_nodes, np.int32)
        off = np.empty(cap_nodes, np.int32)
        cnt = np.empty(cap_nodes, np.int32)
        idx = np.empty(cap_refs, np.int32)
        n_refs = np.zeros(1, np.int32)
        n_nodes = lib.dsrt_build_sbvh(
            np.ascontiguousarray(v0, np.float32),
            np.ascontiguousarray(v1, np.float32),
            np.ascontiguousarray(v2, np.float32),
            n, np.float32(alpha), np.float32(budget), cap_nodes, cap_refs,
            bb_min, bb_max, left, right, off, cnt, idx, n_refs)
        if n_nodes <= 0:
            return None
        m = int(n_refs[0])
        return BVH(bb_min[:n_nodes].copy(), bb_max[:n_nodes].copy(),
                   left[:n_nodes].copy(), right[:n_nodes].copy(),
                   off[:n_nodes].copy(), cnt[:n_nodes].copy(),
                   idx[:m].copy())
    cap = max(2 * n, 1)
    bb_min = np.empty((cap, 3), np.float32)
    bb_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    off = np.empty(cap, np.int32)
    cnt = np.empty(cap, np.int32)
    idx = np.empty(n, np.int32)
    m = {"median": 0, "sah": 1}[method]
    n_nodes = lib.dsrt_build_bvh(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(v1, np.float32),
        np.ascontiguousarray(v2, np.float32),
        n, m, bb_min, bb_max, left, right, off, cnt, idx)
    if n_nodes <= 0:
        return None
    return BVH(bb_min[:n_nodes].copy(), bb_max[:n_nodes].copy(),
               left[:n_nodes].copy(), right[:n_nodes].copy(),
               off[:n_nodes].copy(), cnt[:n_nodes].copy(), idx)
