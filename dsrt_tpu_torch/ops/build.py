"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources under dsrt_tpu_torch/csrc/ (path_kernel.cu and
path_kernel_prims.cu: dsrt_path_render and its instances, and
dsrt_path_occupancy;
sphere_kernel.cu: dsrt_sphere_render and dsrt_sphere_occupancy;
traverse_kernel.cu: dsrt_traverse, the entry of both traversal kernels
(`dsrt_traverse` and `dsrt_traverse_sun` in the wrappers' names), and
dsrt_traverse_occupancy;
exact_math_check.cu: dsrt_exact_math_check, the card's proof of
exact_math.cuh; rdb_conv.cu: dsrt_rdb_conv, the upscaler's dense-block
convs) compile, one
nvcc process per source, all started together, into objects that one
more nvcc call links into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c <source>          (each source)
    nvcc -shared <objects>                      (link)

`-fmad=false` keeps every a*b+c as a rounded multiply then a rounded add,
like the plain PyTorch version (a kernel that wants a fused multiply-add
writes `__fmaf_rn`); fast-math is off so divisions and square roots are
IEEE.  The library lands in <repo>/build/dsrt_tpu_torch/, named
by a hash of the sources and flags, so an edited source rebuilds.  Every
pointer and the stream go through ctypes as c_void_p.

The checks every wrapper's launch shares live here too: `ptr`, `i32`,
`require_cuda`, and for both walkers of the wide table `WIDE_STACK` and
`check_tables`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from dsrt_tpu_torch.models.scene import WIDE_ROW

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dsrt_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # wide, tri, tri_shade, tri_aux, mat, pool, tex_w, tex_h, tex_off,
    # cam, sun, params, pix, accum, counters; width height n_pix cam_w
    # cam_h spp salt seed max_depth rr_start; rr_max_p t_min t_max; n_wide
    # tri_rows n_textures pool_n n_sph n_quads n_lights n_med env flags
    # instance; env_rot env_scale time0 dt; stream
    "dsrt_path_render": ([_P] * 15 + [_I] * 10 + [_F] * 3 + [_I] * 11
                         + [_F] * 4 + [_P]),
    # instance -> resident blocks per SM (negative: a CUDA error)
    "dsrt_path_occupancy": [_I],
    # params, cam, mat, pool, tex_w, tex_h, tex_off, pix, accum, nrays;
    # width height cam_w cam_h spp salt seed max_depth rr_start n_mats
    # n_sph n_med n_lights env n_textures pool_n flags n_pix; rr_max_p
    # t_min t_max env_rot env_scale time0 dt; stream
    "dsrt_sphere_render": [_P] * 10 + [_I] * 18 + [_F] * 7 + [_P],
    # material rows -> resident blocks per SM (negative: a CUDA error)
    "dsrt_sphere_occupancy": [_I],
    # fn n; in, got, lib, mismatches, stream
    "dsrt_exact_math_check": [_I] * 2 + [_P] * 5,
    # bvh, thr, wide, tri, ox oy oz dx dy dz, active, sun (Ldir, bias),
    # t, u, v, tri_out (int64), blocked (bool); n end n_wide tri_rows
    # bcast kind wide; t_min t_max; stream
    "dsrt_traverse": [_P] * 17 + [_I] * 7 + [_F] * 2 + [_P],
    # instance -> resident blocks per SM (negative: a CUDA error)
    "dsrt_traverse_occupancy": [_I],
    # in, wt, bias, out; n h w cin cs_in cout cs_out mode; stream
    "dsrt_rdb_conv": [_P] * 4 + [_I] * 8 + [_P],
}

# the wide walk's stack entries a thread holds (csrc/wide_walk.cuh
# WIDE_STACK), the TPU kernel's (dsrt_tpu/ops/pallas_path.py:470)
WIDE_STACK = 256

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


def _build(out: Path) -> str:
    """Compile every csrc/*.cu in parallel, link them into `out`; return
    the compilers' output, raise with it on failure."""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    logs = []
    try:
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", str(o),
                                                          str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        for s, p in zip(srcs, procs):
            logs.append(f"== {s.name}\n" + p.communicate()[0])
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                                  + [str(o) for o in objs],
                                  capture_output=True, text=True)
            logs.append("== link\n" + link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(logs))
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(out)
        build_info.update(seconds=time.perf_counter() - t0, log=log)
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


def i32(x: int) -> int:
    """A uint32 value as the signed int ctypes passes."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: the kernels take CUDA "
                         "tensors, the plain versions CPU tensors")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA tensors but no CUDA device is available")


def ptr(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    """`t`'s data pointer, once it is a contiguous, 16-byte aligned CUDA
    tensor of `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    return t.data_ptr()


def check_tables(scene, names) -> None:
    """Each named table must be a contiguous, 16-byte aligned float32
    CUDA tensor of (rows, 16) floats, (rows, WIDE_ROW) for wide_pack."""
    for name in names:
        cols = WIDE_ROW if name == "wide_pack" else 16
        t = getattr(scene, name)
        ptr(t, torch.float32, name)
        if t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name}: expected (rows, {cols}), got "
                             f"{tuple(t.shape)}")
