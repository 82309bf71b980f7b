"""Measurements of the megakernels' design that their timings cannot give.

- `tail_share`: per-thread start and end stamps (`%globaltimer`, `%smid`)
  from a stamped copy of the path kernel, built from a patched copy of
  its sources in a temporary directory (`stamped_build`), never in the
  source tree; from them
  the share of the kernel's window in which fewer than all SMs have
  work.  The patch anchors on the kernel's signature line and on its
  last statement (the ray count's atomicAdd), so it applies to this
  tree's kernel and to an earlier one alike.  Where the kernel renders
  a pixel by a call `render_pixel<M>(a, x, y, rays)`, each pixel's own
  start and end are stamped too: the longest pixel, whose samples run
  in order in one thread, is a floor under the frame's time.
- `sphere_tail_shares`: the same stamps from a stamped copy of the
  sphere kernel (built once for all the frames it is given), plus
  `clock64` cycles per pixel spent in each phase of its bounce loop
  (sphere tests and medium tests of the closest-hit query, direction
  sampling, `schlick`, shadow queries, procedural textures), summed
  over the longest 1% of pixels.  Its anchors are statements
  that the sphere kernel of this tree and of earlier trees share.
- `visits_per_query`: the queries of a plain frame, recorded as the
  plain renderer issues them, replayed through `wide_walk_plain`:
  binary and wide node visits per query.

    python3 dsrt_tpu_torch/tools/path_probe.py [--tree DIR] [--reps N]
                                               [--cells | --sphere]

prints one JSON line for the flagship frame (800x450, 32 spp, max_depth
50) rendered by the `dsrt_tpu_torch` package of DIR (default: this
tree): the kernel's mean time over N launches (CUDA events), the tail
share and pixel times of one stamped launch, the card's name and power
limit; with --cells one more line, the kernel's time alone, for each of
the three mixed frames (the mixed stand-in and the volumetric mesh at
800x450, `mixed_scene` at 400x225, all 32 spp).  With --sphere, one line
for each sphere frame (rtiow 400x225 spp 64, volumetric 800x450 spp 32)
in place of the flagship's: the sphere kernel's time (CUDA events), the
frame wall of `render_frame_fused`, the device busy share of a profiled
frame, the kernel's registers, and the stamped copy's tail share, pixel
times and phase shares.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import fnmatch
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# stamps of at most this many threads a launch
MAX_THREADS = 1 << 20

_DEFS = r'''
// ---- probe: per-thread start and end stamps ----
static __device__ unsigned long long* probe_buf;
static __device__ unsigned long long* probe_pix;
__device__ __forceinline__ unsigned long long probe_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_stamp(unsigned long long t0) {
  unsigned long long t1 = probe_clock();
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  unsigned long long i =
      ((unsigned long long)blockIdx.x + (unsigned long long)gridDim.x * blockIdx.y) *
          (blockDim.x * blockDim.y) + threadIdx.y * blockDim.x + threadIdx.x;
  if (probe_buf != nullptr && i < MAX_THREADSull) {
    probe_buf[3 * i] = sm;
    probe_buf[3 * i + 1] = t0;
    probe_buf[3 * i + 2] = t1;
  }
}
__device__ __forceinline__ void probe_pixel(int x, int y, int w, unsigned long long t0) {
  unsigned long long t1 = probe_clock();
  if (probe_pix != nullptr) {
    probe_pix[2 * ((size_t)y * w + x)] = t0;
    probe_pix[2 * ((size_t)y * w + x) + 1] = t1;
  }
}
'''.replace("MAX_THREADS", str(MAX_THREADS))

_SETTER = r'''
extern "C" int dsrt_probe_set(void* p, void* pix) {
  cudaError_t e = cudaMemcpyToSymbol(probe_buf, &p, sizeof(p));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(probe_pix, &pix, sizeof(pix));
  return (int)e;
}
'''


def _patch(csrc: Path) -> None:
    """Add the stamps to the copy of csrc/ at `csrc` (instances of
    path_kernel.cu, the flagship's among them, report)."""
    hdr = csrc / "path_kernel.cuh"
    lines = hdr.read_text().splitlines(keepends=True)
    out, seen = [], {"include": 0, "entry": 0, "exit": 0}
    for ln in lines:
        out.append(ln)
        if ln.strip() == '#include "common.cuh"':
            out.append(_DEFS)
            seen["include"] += 1
        elif "path_render_kernel(const PathArgs a) {" in ln:
            out.append("  const unsigned long long probe_t0 = probe_clock();\n")
            seen["entry"] += 1
        elif "atomicAdd(a.nrays," in ln:
            out.append("  probe_stamp(probe_t0);\n")
            seen["exit"] += 1
        elif "render_pixel<M>(a, x, y, rays);" in ln:
            out[-1] = ("const unsigned long long probe_p0 = probe_clock();\n"
                       + ln + "probe_pixel(x, y, a.width, probe_p0);\n")
    if seen != {"include": 1, "entry": 1, "exit": 1}:
        raise RuntimeError(f"path_kernel.cuh anchors not found once: {seen}")
    hdr.write_text("".join(out))
    cu = csrc / "path_kernel.cu"
    cu.write_text(cu.read_text() + _SETTER)


# the sphere kernel's phases: (name, call replaced in trace_path, probe
# wrapper); the closest-hit query's sphere and medium loops are stamped
# by line anchors (PHASES[0:2])
PHASES = ("sphere tests", "medium tests", "direction sampling", "schlick",
          "shadow queries", "procedural textures")
_CALLS = (("sample_cosine_hemisphere(n, st,", "probe_cosine_hemisphere(n, st,"),
          ("sphere_light_sample(", "probe_light_sample("),
          ("schlick(cos_t, ratio)", "probe_schlick(cos_t, ratio)"),
          ("blocked(a, sh_o, sdir, tm, st)", "probe_blocked(a, sh_o, sdir, tm, st)"),
          ("procedural(mp, albedo, p)", "probe_procedural(mp, albedo, p)"))
# per pixel: start, end (globaltimer), cycles of the pixel, cycles of
# each phase
PIX_COLS = 3 + len(PHASES)

_SPHERE_DEFS = r'''
// ---- probe: per-thread phase cycles, copied to the pixel's row ----
static __device__ unsigned long long* probe_cyc;
__device__ __forceinline__ unsigned long long probe_tid() {
  return ((unsigned long long)blockIdx.x + (unsigned long long)gridDim.x * blockIdx.y) *
             (blockDim.x * blockDim.y) + threadIdx.y * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ void probe_add(int k, long long dt) {
  unsigned long long i = probe_tid();
  if (probe_cyc != nullptr && i < MAX_THREADSull) probe_cyc[NPHASE * i + k] += dt;
}
__device__ __forceinline__ void probe_sphere_pixel(int x, int y, int w, unsigned long long t0,
                                                   long long c0) {
  long long c1 = clock64();
  unsigned long long t1 = probe_clock();
  unsigned long long i = probe_tid();
  if (probe_pix == nullptr || probe_cyc == nullptr || i >= MAX_THREADSull) return;
  unsigned long long* row = probe_pix + PIX_COLS * ((size_t)y * w + x);
  row[0] = t0;
  row[1] = t1;
  row[2] = c1 - c0;
  for (int k = 0; k < NPHASE; ++k) {
    row[3 + k] = probe_cyc[NPHASE * i + k];
    probe_cyc[NPHASE * i + k] = 0;
  }
}
'''

_SPHERE_WRAPPERS = r'''
// ---- probe: the phases' calls, timed ----
__device__ __forceinline__ f3 probe_cosine_hemisphere(f3 n, uint32_t& s, float& pdf) {
  long long c = clock64();
  f3 r = sample_cosine_hemisphere(n, s, pdf);
  probe_add(2, clock64() - c);
  return r;
}
__device__ __forceinline__ f3 probe_light_sample(f3 c, float radius, f3 origin, float uz,
                                                 float uphi, float& pdf) {
  long long t = clock64();
  f3 r = sphere_light_sample(c, radius, origin, uz, uphi, pdf);
  probe_add(2, clock64() - t);
  return r;
}
__device__ __forceinline__ float probe_schlick(float cosine, float ref_idx) {
  long long c = clock64();
  float r = schlick(cosine, ref_idx);
  probe_add(3, clock64() - c);
  return r;
}
__device__ __forceinline__ bool probe_blocked(const Args& a, f3 ro, f3 rd, float tm,
                                              uint32_t& st) {
  long long c = clock64();
  bool r = blocked(a, ro, rd, tm, st);
  probe_add(4, clock64() - c);
  return r;
}
__device__ __forceinline__ f3 probe_procedural(const float* mp, f3 base, f3 p) {
  long long c = clock64();
  f3 r = procedural(mp, base, p);
  probe_add(5, clock64() - c);
  return r;
}
'''

_SPHERE_SETTER = r'''
extern "C" int dsrt_probe_set(void* p, void* pix, void* cyc) {
  cudaError_t e = cudaMemcpyToSymbol(probe_buf, &p, sizeof(p));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(probe_pix, &pix, sizeof(pix));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(probe_cyc, &cyc, sizeof(cyc));
  return (int)e;
}
extern "C" const char* dsrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
'''


def _patch_sphere(csrc: Path) -> None:
    """Add the stamps and the phase cycles to the copy of csrc/ at
    `csrc` (sphere_kernel.cu)."""
    src = csrc / "sphere_kernel.cu"
    defs = (_DEFS + _SPHERE_DEFS).replace("NPHASE", str(len(PHASES))).replace(
        "PIX_COLS", str(PIX_COLS)).replace("MAX_THREADS", str(MAX_THREADS))
    out, where = [], None
    seen = dict.fromkeys(("include", "entry", "exit", "pixel", "hit", "media",
                          "return", "trace") + tuple(c for c, _ in _CALLS), 0)
    for ln in src.read_text().splitlines(keepends=True):
        s = ln.strip()
        if s.startswith("__device__ Hit closest_hit("):
            where = "hit"
        elif s.startswith("__device__ f3 trace_path("):
            out.append(_SPHERE_WRAPPERS)
            where = "trace"
            seen["trace"] += 1
        elif s.startswith("__device__ f3 render_pixel("):
            where = None
        if where == "trace":
            for call, probe in _CALLS:
                if call in ln:
                    ln = ln.replace(call, probe)
                    seen[call] += 1
        if where == "hit" and s.startswith("if (a.n_med > 0) {"):
            out.append("  long long probe_c1 = clock64();\n"
                       "  probe_add(0, probe_c1 - probe_c0);\n")
            seen["media"] += 1
        if where == "hit" and s == "return h;":
            out.append("  probe_add(1, clock64() - probe_c1);\n")
            seen["return"] += 1
            where = None
        if "render_pixel(a, mats, x, y, rays);" in ln:
            ln = ("const unsigned long long probe_p0 = probe_clock();\n"
                  "const long long probe_q0 = clock64();\n" + ln
                  + "probe_sphere_pixel(x, y, a.width, probe_p0, probe_q0);\n")
            seen["pixel"] += 1
        out.append(ln)
        if s == '#include "prims.cuh"':
            out.append(defs)
            seen["include"] += 1
        elif "sphere_render_kernel(const Args a) {" in ln:
            out.append("  const unsigned long long probe_t0 = probe_clock();\n")
            seen["entry"] += 1
        elif "atomicAdd(a.nrays," in ln:
            out.append("  probe_stamp(probe_t0);\n")
            seen["exit"] += 1
        elif where == "hit" and s.startswith("Hit h{"):
            out.append("  long long probe_c0 = clock64();\n")
            seen["hit"] += 1
    want = dict.fromkeys(seen, 1)
    want["sample_cosine_hemisphere(n, st,"] = 2
    if seen != want:
        raise RuntimeError(f"sphere_kernel.cu anchors not found once: {seen}")
    src.write_text("".join(out) + _SPHERE_SETTER)


def tail_share_of(stamps: np.ndarray, n_sms: int) -> dict:
    """From (sm, t0, t1) rows: the kernel window, the share of it in which
    fewer than `n_sms` SMs had a thread running, and the SMs' busy
    shares."""
    stamps = stamps[stamps[:, 2] > 0]
    sm, t0, t1 = (stamps[:, k].astype(np.int64) for k in range(3))
    lo, hi = int(t0.min()), int(t1.max())
    events = []
    busy = []
    for s in np.unique(sm):
        a, b = t0[sm == s], t1[sm == s]
        order = np.argsort(a)
        a, b = a[order], np.maximum.accumulate(b[order])
        start = np.ones(len(a), bool)
        start[1:] = a[1:] > b[:-1]
        ends = np.append(b[np.nonzero(start)[0][1:] - 1], b[-1])
        starts = a[start]
        busy.append(int((ends - starts).sum()))
        events += [(x, 1) for x in starts] + [(x, -1) for x in ends]
    events.sort()
    short, level, prev = 0, 0, lo
    for x, step in events:
        if level < n_sms:
            short += x - prev
        level += step
        prev = x
    short += hi - prev
    window = max(hi - lo, 1)
    busy = np.asarray(busy, np.float64) / window
    return {"window_ms": window / 1e6, "tail_share": short / window,
            "sms_seen": int(len(np.unique(sm))), "sms": n_sms,
            "sm_busy_mean": float(busy.mean()),
            "sm_busy_min": float(busy.min()),
            "threads": int(len(sm))}


def pixel_times_of(pix: np.ndarray, window_start: int) -> dict:
    """From per-pixel (start, end) stamps: the longest pixel, its start
    after the window's, and the pixel-time quantiles, in ms."""
    pix = pix[pix[:, 1] > 0].astype(np.int64)
    if not len(pix):
        return {}
    dur = (pix[:, 1] - pix[:, 0]) / 1e6
    k = int(np.argmax(dur))
    q = np.quantile(dur, [0.5, 0.9, 0.99, 0.999])
    return {"pixel_max_ms": float(dur[k]),
            "pixel_max_start_ms": (int(pix[k, 0]) - window_start) / 1e6,
            "pixel_p50_ms": float(q[0]), "pixel_p90_ms": float(q[1]),
            "pixel_p99_ms": float(q[2]), "pixel_p999_ms": float(q[3]),
            "pixel_sum_ms": float(dur.sum())}


@contextlib.contextmanager
def stamped_build(patch, sources: str):
    """For its duration, this package's wrappers launch kernels built
    from a copy of csrc/ (in a temporary directory under build/) that
    holds the headers and only the .cu files whose names match the glob
    `sources`, patched by `patch`.  Yields `stamp(render, buffers)`: it hands the zeroed int64
    `buffers` to the copy's `dsrt_probe_set`, runs `render()` twice (a
    warm-up, then the stamped run) and returns the buffers as numpy
    arrays."""
    import ctypes

    import torch

    from dsrt_tpu_torch.ops import build
    saved = (build.CSRC, build.BUILD_DIR, build._lib, dict(build.build_info),
             build.SIGNATURES)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as td:
        csrc = Path(td) / "csrc"
        shutil.copytree(saved[0], csrc)
        for cu in csrc.glob("*.cu"):
            if not fnmatch.fnmatch(cu.name, sources):
                cu.unlink()
        patch(csrc)
        build.CSRC, build.BUILD_DIR, build._lib = csrc, Path(td), None
        # bind only the entry points the kept sources define
        text = "".join(f.read_text() for f in csrc.glob("*.cu"))
        build.SIGNATURES = {k: v for k, v in saved[4].items()
                            if f"{k}(" in text}
        try:
            lib = build.load()

            def stamp(render, buffers):
                lib.dsrt_probe_set.argtypes = [ctypes.c_void_p] * len(buffers)
                lib.dsrt_probe_set.restype = ctypes.c_int
                render()   # warm-up
                torch.cuda.synchronize()
                for b in buffers:
                    b.zero_()
                build.check(lib, lib.dsrt_probe_set(
                    *(b.data_ptr() for b in buffers)), "dsrt_probe_set")
                render()
                torch.cuda.synchronize()
                out = [b.cpu().numpy() for b in buffers]
                build.check(lib, lib.dsrt_probe_set(*([None] * len(buffers))),
                            "dsrt_probe_set")
                return out

            yield stamp
        finally:
            (build.CSRC, build.BUILD_DIR, build._lib,
             build.SIGNATURES) = saved[0], saved[1], saved[2], saved[4]
            build.build_info.clear()
            build.build_info.update(saved[3])


def tail_share(scene, cam, cfg) -> dict:
    """Tail share of one launch of a stamped copy of this package's path
    kernel (`path_kernel.path_render` on a CUDA scene), and its pixel
    times where the kernel has a per-pixel call."""
    import torch

    from dsrt_tpu_torch.ops import path_kernel
    buf = torch.zeros(3 * MAX_THREADS, dtype=torch.int64, device=scene.device)
    pix = torch.zeros(2 * cfg.width * cfg.height, dtype=torch.int64,
                      device=scene.device)
    with stamped_build(_patch, "path_kernel*.cu") as stamp:
        stamps, pixels = stamp(
            lambda: path_kernel.path_render(scene, cam, cfg), [buf, pix])
    stamps, pixels = stamps.reshape(-1, 3), pixels.reshape(-1, 2)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = tail_share_of(stamps, n_sms)
    start = int(stamps[stamps[:, 2] > 0, 1].astype(np.int64).min())
    return dict(out, **pixel_times_of(pixels, start))


def phase_shares_of(pix: np.ndarray, top: float = 0.01) -> dict:
    """From per-pixel rows (start, end, cycles, phase cycles...): each
    phase's share of the cycles of the longest `top` of pixels (by
    globaltimer duration), and over all pixels."""
    pix = pix[pix[:, 1] > 0].astype(np.int64)
    dur = pix[:, 1] - pix[:, 0]
    k = max(1, int(round(top * len(pix))))
    longest = pix[np.argsort(dur)[-k:]]
    out = {}
    for name, rows in (("longest", longest), ("all", pix)):
        total = max(int(rows[:, 2].sum()), 1)
        out[f"phase_share_{name}"] = {
            p: float(rows[:, 3 + j].sum()) / total
            for j, p in enumerate(PHASES)}
    out["phase_pixels_longest"] = int(k)
    return out


def sphere_tail_shares(frames) -> list:
    """For each (scene, camera, config) of `frames` (CUDA scenes): tail
    share, pixel times and phase shares of one launch of a stamped copy
    of this package's sphere kernel (`sphere_kernel.sphere_render`),
    built once from sphere_kernel.cu alone."""
    import torch

    from dsrt_tpu_torch.ops import sphere_kernel
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    with stamped_build(_patch_sphere, "sphere_kernel.cu") as stamp:
        for scene, cam, cfg in frames:
            dev = scene.device
            buf = torch.zeros(3 * MAX_THREADS, dtype=torch.int64, device=dev)
            pix = torch.zeros(PIX_COLS * cfg.width * cfg.height,
                              dtype=torch.int64, device=dev)
            cyc = torch.zeros(len(PHASES) * MAX_THREADS, dtype=torch.int64,
                              device=dev)
            stamps, pixels, _ = stamp(
                lambda: sphere_kernel.sphere_render(scene, cam, cfg),
                [buf, pix, cyc])
            stamps = stamps.reshape(-1, 3)
            pixels = pixels.reshape(-1, PIX_COLS)
            start = int(stamps[stamps[:, 2] > 0, 1].astype(np.int64).min())
            out.append(dict(tail_share_of(stamps, n_sms),
                            **pixel_times_of(pixels[:, :2], start),
                            **phase_shares_of(pixels)))
    return out


def visits_per_query(scene, cam, cfg) -> dict:
    """Node visits per query of a plain frame (CPU or CUDA scene): the
    binary walk's, counted as the frame runs, and the wide walk's, from
    the same queries replayed through `wide_walk_plain`."""
    from dsrt_tpu_torch.ops import path_kernel, trace
    calls = []
    walk = trace.lane_traverse

    def recording(scene_, ro, rd, t_min, t_max, active, any_hit=False):
        calls.append((ro, rd, t_min, t_max, active.clone(), any_hit))
        return walk(scene_, ro, rd, t_min, t_max, active, any_hit=any_hit)

    trace.lane_traverse = recording
    try:
        with trace.walk_counter() as binary:
            path_kernel.path_render_plain(scene, cam, cfg, cfg.spp)
    finally:
        trace.lane_traverse = walk
    with trace.walk_counter() as wide:
        for ro, rd, t_min, t_max, active, any_hit in calls:
            trace.wide_walk_plain(scene, ro, rd, t_min, t_max, active,
                                  any_hit=any_hit)
    queries = sum(int(c[4].sum()) for c in calls)
    out = {"queries": queries, "binary_visits": int(binary["visits"]),
           "wide_visits": int(wide["wide_visits"]),
           "binary_tests": int(binary["tests"]),
           "wide_tests": int(wide["wide_tests"])}
    out["binary_per_query"] = out["binary_visits"] / max(queries, 1)
    out["wide_per_query"] = out["wide_visits"] / max(queries, 1)
    return out


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def flagship(device):
    """The flagship scene (textured 51k stand-in), camera and config."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                                write_panel_texture)
    from dsrt_tpu_torch.ops.camera import point_camera_at
    cfg = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    with tempfile.TemporaryDirectory() as td:
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex)
        scene = iss_standin_scene(detail=12, tex_path=tex, device="cpu")
    cam = point_camera_at((40.0, 60.0, 190.0), vfov=cfg.vfov, width=800,
                          height=450, device="cpu")
    return scene.to(device), cam.to(device), cfg


def mixed_cells(device):
    """(name, scene, camera, config) of the three mixed frames."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.mesh_gen import (iss_mixed_scene,
                                                iss_standin_mesh)
    from dsrt_tpu_torch.models.scene import SceneBuilder
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    big = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    small = RenderConfig(width=400, height=225, spp=32, max_depth=50)
    station = point_camera_at((40.0, 60.0, 190.0), vfov=big.vfov, width=800,
                              height=450, device=device)
    yield ("mixed stand-in", iss_mixed_scene(detail=12, device=device),
           station, big)
    yield ("mixed_scene", presets.mixed_scene(device=device),
           make_camera((0, 0.8, 2.6), (0, 0.3, -1), vfov=50, width=400,
                       height=225, device=device), small)
    yield ("volumetric mesh",
           fs.volumetric_mesh(SceneBuilder, Material,
                              standin_mesh=iss_standin_mesh,
                              detail=4).build(device=device), station, big)


def event_ms(fn, reps: int) -> float:
    """Mean time of `reps` calls of `fn` after a warm-up (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(scene, cam, cfg, reps: int) -> float:
    """Mean time of `reps` launches of the path kernel (CUDA events)."""
    from dsrt_tpu_torch.ops import path_kernel
    return event_ms(lambda: path_kernel.path_render(scene, cam, cfg), reps)


def sphere_frames(device):
    """(name, scene, camera, config) of the two full-size sphere frames:
    rtiow 400x225 spp 64 and volumetric 800x450 spp 32, max_depth 50,
    camera (0, 0.6, 2) -> (0, 0, -1), vfov 50."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.ops.camera import make_camera
    for name, w, h, spp in (("rtiow_smoke_scene", 400, 225, 64),
                            ("volumetric_scene", 800, 450, 32)):
        yield (name, getattr(presets, name)(device=device),
               make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=50,
                           width=w, height=h, device=device),
               RenderConfig(width=w, height=h, spp=spp, max_depth=50))


def frame_profile(fn, reps: int) -> dict:
    """`fn` (one frame, ending on the host) timed: the least wall of
    `reps` calls, and one call under torch.profiler with its wall, the
    device time of the sphere kernel and of all device work, and the
    device idle share of that call's wall."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = kern = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0 or getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        busy += us / 1e3
        if "sphere_render_kernel" in e.key:
            kern += us / 1e3
    return {"frame_ms": min(walls), "frame_walls_ms": walls,
            "profiled_wall_ms": wall, "profiled_kernel_ms": kern,
            "profiled_busy_ms": busy, "idle_share": 1.0 - busy / wall}


def sphere_registers() -> int | None:
    """The sphere kernel's registers from the build's -Xptxas -v log."""
    import re

    from dsrt_tpu_torch.ops import build
    build.load()
    name = None
    for ln in build.build_info.get("log", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and "sphere_render_kernel" in name:
            return int(m.group(1))
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--reps", type=int, default=10)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--cells", action="store_true")
    mode.add_argument("--sphere", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("path_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    tree, name = str(Path(args.tree).resolve()), card()
    if args.sphere:
        from dsrt_tpu_torch.ops import sphere_kernel
        from dsrt_tpu_torch.render import render_frame_fused
        regs = sphere_registers()
        frames = list(sphere_frames(dev))
        rows = []
        for cell, scene, cam, cfg in frames:
            k = event_ms(lambda: sphere_kernel.sphere_render(scene, cam, cfg),
                         args.reps)
            fr = frame_profile(lambda: render_frame_fused(scene, cam, cfg),
                               args.reps)
            rows.append({
                "tree": tree, "card": name, "cell": cell,
                "shape": f"{cfg.width}x{cfg.height} spp{cfg.spp}",
                "kernel_ms": k, "reps": args.reps, "registers": regs,
                "frame_minus_kernel_ms": fr["frame_ms"] - k, **fr})
        stamped = sphere_tail_shares([f[1:] for f in frames])
        for row, t in zip(rows, stamped):
            print(json.dumps(dict(row, **t)), flush=True)
        return 0
    scene, cam, cfg = flagship(dev)
    print(json.dumps({"tree": tree, "card": name, "cell": "flagship",
                      "kernel_ms": kernel_ms(scene, cam, cfg, args.reps),
                      "reps": args.reps, **tail_share(scene, cam, cfg)}),
          flush=True)
    for cell, scene, cam, cfg in (mixed_cells(dev) if args.cells else ()):
        print(json.dumps({"tree": tree, "card": name, "cell": cell,
                          "kernel_ms": kernel_ms(scene, cam, cfg, args.reps),
                          "reps": args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
