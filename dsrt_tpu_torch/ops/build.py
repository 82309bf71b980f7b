"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources under dsrt_tpu_torch/csrc/ compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC

`-fmad=false` keeps every a*b+c as a rounded multiply then a rounded add,
like the plain PyTorch version; fast-math is off so divisions and square
roots are IEEE.  The library lands in <repo>/build/dsrt_tpu_torch/, named
by a hash of the sources and flags, so an edited source rebuilds.  Every
pointer and the stream go through ctypes as c_void_p.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dsrt_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # bvh, thr, tri, tri_shade, mat, pool, tex_w, tex_h, tex_off, cam,
    # sun, accum, nrays; width height cam_w cam_h spp salt seed max_depth
    # rr_start; rr_max_p t_min t_max; end tri_rows n_textures pool_n
    # sun_on textured; stream
    "dsrt_path_render": [_P] * 13 + [_I] * 9 + [_F] * 3 + [_I] * 6 + [_P],
    # bvh, thr, tri, ro, rd, t, u, v, tri_out; n end tri_rows;
    # t_min t_max; stream
    "dsrt_closest_hit": [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P],
}

_lib = None
build_info: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        exe = Path(cand) / "bin" / "nvcc"
        if cand and exe.exists():
            return str(exe)
    exe = shutil.which("nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return exe


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdsrt_torch_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
               + [str(s) for s in sorted(CSRC.glob("*.cu"))])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    else:
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "(cached build)")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dsrt_error_string.argtypes = [ctypes.c_int]
    lib.dsrt_error_string.restype = ctypes.c_char_p
    build_info["path"] = str(out)
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib.dsrt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
