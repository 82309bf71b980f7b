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
- `record_waves`, `wave_work`, `traverse_probe`: the traversal kernels
  at the shapes a split frame launches them (its second full-width wave,
  its last full-width wave and its first drain wave, for the closest,
  any-hit and sun queries) and at 2^20 random rays: active share, node
  visits per query of both walks, the bound, the wrapper's time and the
  kernel's device time; `traverse_resources` and `launch_ops`: registers,
  stack bytes and resident blocks of each instance, and what one launch
  issues.

    python3 dsrt_tpu_torch/tools/path_probe.py [--tree DIR] [--reps N]
                                               [--cells | --sphere |
                                                --rendezvous |
                                                --traverse [--frames]
                                                [--waves FILE]]

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
times and phase shares.  With --traverse, the traversal kernels of DIR
on the recorded waves of the untextured stand-in's split frame (800x450,
32 spp, depth 50, spp_batch 4) and on 2^20 random rays, one line each
per walk (8-ary, binary), plus the instances' resources and
one launch's ops; the records are saved to FILE (default
build/traverse_waves.pt) by the first run and read by later ones, so
two trees time the same rays.  --frames adds the split frames' walls.
With --rendezvous, one line for each of RENDEZVOUS_POSES of the
rendezvous sequence at one of Run B's chunk launches (1920x1080, 129
spp) in place of the flagship's: the kernel's time, tail share and
pixel times.  Needs one CUDA device.
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
# the rendezvous poses --rendezvous probes: the first, the last two on
# either side of the render stage's drop between 41 and 42, the middle
# and the last
RENDEZVOUS_POSES = (0, 41, 42, 49, 98)

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
        elif "sphere_list_kernel(const Args a) {" in ln:
            where = "list"   # the list kernel is not stamped
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
        elif "atomicAdd(a.nrays," in ln and where != "list":
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


def random_rays(n: int, seed: int, device):
    """Rays from a shell around the station: half aimed at it, half in
    random directions (numpy, from a seed)."""
    import torch

    from dsrt_tpu_torch.ops.linalg import V3
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o *= (60.0 + 140.0 * rng.random(n)) / np.linalg.norm(o, axis=0)
    tgt = rng.normal(scale=15.0, size=(3, n))
    d = rng.normal(size=(3, n))
    d[:, : n // 2] = tgt[:, : n // 2] - o[:, : n // 2]
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return (V3(*(torch.from_numpy(c).to(device) for c in o)),
            V3(*(torch.from_numpy(c).to(device) for c in d)))


# the split frame whose waves the traversal probe records: the untextured
# 51k stand-in at the flagship view, 800x450, 32 spp, depth 50,
# spp_batch 4 (chip_smoke.py phase 11)
SPLIT_VIEW = (40.0, 60.0, 190.0)
QUERY_KINDS = ("closest", "any", "sun")
# the recorded waves of each query kind: the second full-width wave
# (the first bounce), the last full-width wave, the first drain wave
WAVES = ("bounce 1", "late full width", "drain")


def split_frame(device, scene=None):
    """The split frame's scene (the untextured stand-in, unless given),
    camera and config."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
    from dsrt_tpu_torch.ops.camera import point_camera_at
    cfg = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    if scene is None:
        scene = iss_standin_scene(detail=12, device="cpu").to(device)
    cam = point_camera_at(SPLIT_VIEW, vfov=cfg.vfov, width=800, height=450,
                          device=device)
    return scene, cam, cfg


def _keep(c, shape):
    """A copy of a ray component: a component that is one value for every
    ray stays one value (0-dim), as the shadow query's direction is."""
    if c.dim() == 0 or all(s == 0 for s in c.stride()):
        return c.reshape(-1)[:1].reshape(()).clone()
    return c.expand(shape).clone()


def record_waves(scene, cam, cfg, spp_batch: int = 4) -> list:
    """The traversal calls of a split frame (`render_frame_wavefront`,
    fused_sun off for the closest and any-hit queries, on for the sun
    query), kept for the waves of WAVES: a list of dicts (kind, wave,
    rows, ro, rd, active) with the tensors on the card."""
    import torch

    from dsrt_tpu_torch.exec_opts import OPTS
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.render import render_frame_wavefront
    calls = {k: [] for k in QUERY_KINDS}
    kept = {}
    full_rows = [0]
    orig = tv.traverse, tv.traverse_with_sun

    def note(kind, ro, rd, active):
        rows = active.shape[0]
        full_rows[0] = max(full_rows[0], rows)
        i = len(calls[kind])
        calls[kind].append(rows)
        drain = rows < full_rows[0]
        wave = ("drain" if drain else
                "bounce 1" if i == 1 else "late full width")
        if wave == "drain" and (kind, "drain") in kept:
            return
        if wave == "late full width" or (kind, wave) not in kept:
            shape = active.shape
            kept[(kind, wave)] = dict(
                kind=kind, wave=wave, rows=rows, call=i,
                ro=[_keep(c, shape) for c in ro],
                rd=[_keep(c, shape) for c in rd], active=active.clone())

    def traverse(scene_, ro, rd, active, t_min, t_max, any_hit=False):
        note("any" if any_hit else "closest", ro, rd, active)
        return orig[0](scene_, ro, rd, active, t_min, t_max, any_hit=any_hit)

    def traverse_with_sun(scene_, ro, rd, active, t_min, t_max, sun_ldir,
                          shadow_bias, *rest):
        note("sun", ro, rd, active)
        return orig[1](scene_, ro, rd, active, t_min, t_max, sun_ldir,
                       shadow_bias, *rest)

    tv.traverse, tv.traverse_with_sun = traverse, traverse_with_sun
    try:
        for fused in (False, True):
            OPTS.fused_sun = fused
            render_frame_wavefront(scene, cam, cfg, spp_batch=spp_batch)
    finally:
        OPTS.fused_sun = False
        tv.traverse, tv.traverse_with_sun = orig
    torch.cuda.synchronize()
    return [kept[(k, w)] for k in QUERY_KINDS for w in WAVES]


def wave_work(scene, rec: dict, sample: int = 2048) -> dict:
    """Active share, the binary walk's visits and tests on every active
    ray (the plain walk on the card, for the bound), and binary and wide
    visits per query on a CPU sample of `sample` active rays."""
    import torch

    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.ops.linalg import V3
    from dsrt_tpu_torch.ops.shade import sun_direction
    from dsrt_tpu_torch.ops.trace import (lane_traverse, walk_counter,
                                          wide_walk_plain)
    act = rec["active"]
    shape = act.shape
    ro = V3(*(c.expand(shape) for c in rec["ro"]))
    rd = V3(*(c.expand(shape) for c in rec["rd"]))
    sdir = sun_direction(scene)

    def run(sc, o, d, a, walk):
        # the sun query as the kernel composes it (traverse_with_sun_plain)
        got = walk(sc, o, d, 1e-3, 1e9, a, any_hit=rec["kind"] == "any")
        if rec["kind"] == "sun":
            so = tv.sun_origin(sc, o, d, got[0], got[3], 1e-3)
            sun = V3(*(c.to(got[0].device).expand(got[0].shape)
                       for c in sdir))
            walk(sc, so, sun, 1e-3, 1e9, got[3] >= 0, any_hit=True)

    with walk_counter() as full:
        run(scene, ro, rd, act, lane_traverse)
    idx = torch.nonzero(act.reshape(-1)).reshape(-1)
    pick = idx[torch.randperm(idx.numel(), generator=torch.Generator()
                              .manual_seed(0))[:sample].to(idx.device)]
    cpu = scene.to("cpu")
    so = V3(*(c.reshape(-1)[pick].cpu() for c in ro))
    sd = V3(*(c.reshape(-1)[pick].cpu() for c in rd))
    sa = torch.ones(pick.numel(), dtype=torch.bool)
    with walk_counter() as binary:
        run(cpu, so, sd, sa, lane_traverse)
    with walk_counter() as wide:
        run(cpu, so, sd, sa, wide_walk_plain)
    n_act = int(act.sum())
    rays_in = tv.ray_bytes(V3(*rec["ro"]), V3(*rec["rd"]), n_act)
    bound, by = tv.bound_ms(scene, act.numel(), rays_in, int(full["visits"]),
                            int(full["tests"]), with_sun=rec["kind"] == "sun")
    return {"lanes": act.numel(), "active": n_act,
            "active_share": n_act / act.numel(),
            "visits": int(full["visits"]), "tests": int(full["tests"]),
            "bound_ms": bound, "bound_by": by, "sample": pick.numel(),
            "binary_per_query": int(binary["visits"]) / max(pick.numel(), 1),
            "wide_per_query": int(wide["wide_visits"]) / max(pick.numel(),
                                                              1)}


def random_records(device, n: int = 1 << 20) -> list:
    """chip_smoke.py phase 9's 2^20 random rays (90% active) as records
    of each query kind."""
    import torch
    ro, rd = random_rays(n, 11, device)
    act = torch.from_numpy(np.random.default_rng(12).random(n) > 0.1).to(
        device)
    return [dict(kind=k, wave="2^20 random", rows=1, call=0, ro=list(ro),
                 rd=list(rd), active=act) for k in QUERY_KINDS]


def traverse_call(scene, rec: dict):
    """A thunk launching the record's query through the wrapper."""
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.ops.linalg import V3
    from dsrt_tpu_torch.ops.shade import sun_direction
    act = rec["active"]
    ro, rd = V3(*rec["ro"]), V3(*(c.expand(act.shape) if c.dim() == 0
                                  else c for c in rec["rd"]))
    if rec["kind"] == "sun":
        sdir = sun_direction(scene)
        # the sun vector made once, as the wave loops make it once a frame
        sun = tv.sun_vector(sdir, 1e-3)
        return lambda: tv.traverse_with_sun(scene, ro, rd, act, 1e-3, 1e9,
                                            sdir, 1e-3, sun)
    return lambda: tv.traverse(scene, ro, rd, act, 1e-3, 1e9,
                               any_hit=rec["kind"] == "any")


def _profiled(fn, reps: int, tries: int = 4):
    """torch.profiler's device records over `reps` calls of `fn` (after
    one call outside it), taken again until the session has recorded a
    traversal kernel: the profiler can record none, most often in a
    session that traces the host too, late in a process that ran other
    sessions.  Raises when `tries` sessions recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if any("traverse" in e.name and getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA for e in prof.events()):
            return prof
    raise RuntimeError(f"torch.profiler recorded no traversal kernel in "
                       f"{tries} sessions of {reps} calls")


def launch_ops(fn, reps: int = 5) -> dict:
    """What one call of `fn` (a traversal wrapper call) issues, from
    torch.profiler over `reps` calls: the work items on the device
    (kernels, memsets, copies; a session of device records, `_profiled`)
    and the top-level aten ops on the host (a session of host records),
    each the most that any one name was recorded, per call (the profiler
    can miss a record)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = collections.Counter(
        e.name for e in _profiled(fn, reps).events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    host = collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("aten::")
                               and e.cpu_parent is None)
    per_call = {k: -(-n // reps) for k, n in dev.items()}
    return {"device_ops": sum(per_call.values()),
            "device_names": sorted(per_call),
            "aten_ops": sum(-(-n // reps) for n in host.values()),
            "aten_names": sorted(host)}


def kernel_device_ms(fn, reps: int) -> float:
    """Mean device time of one launch of the traversal kernels (every
    kernel whose name holds "traverse"), from torch.profiler over `reps`
    calls: the recorded time over the recorded launches, so a record the
    profiler missed does not count as a launch of no time."""
    us = n = 0
    for e in _profiled(fn, reps).key_averages():
        if "traverse" in e.key and getattr(e, "self_device_time_total", 0):
            us += e.self_device_time_total
            n += e.count
    if n == 0:
        raise RuntimeError("torch.profiler recorded no traversal kernel time")
    return us / 1e3 / n


def traverse_resources() -> dict:
    """Resident blocks of 256 per SM of each traversal kernel instance
    (the library's occupancy call), with its registers, stack frame and
    spill bytes from the build's -Xptxas -v log (absent when the library
    was built by an earlier process)."""
    import re

    from dsrt_tpu_torch.ops import build
    lib = build.load()
    out, name = {}, None
    for ln in build.build_info.get("log", "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", ln)
        if m:
            name = m.group(1) if "traverse" in m.group(1) else None
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      ln)
        if m:
            out[name].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    named = {}
    # instance = kind + 3 * wide, as the library numbers them
    for instance in range(2 * len(QUERY_KINDS)):
        kind, wide = instance % 3, instance // 3
        mangled = f"traverse_kernelILi{kind}ELb{wide}E"
        res = next((r for k, r in out.items() if mangled in k), {})
        named[f"{QUERY_KINDS[kind]}/{'wide' if wide else 'binary'}"] = dict(
            res, blocks_per_sm=lib.dsrt_traverse_occupancy(instance))
    return named


def traverse_probe(scene, records: list, reps: int) -> list:
    """For each record: its work (`wave_work`, computed once and kept in
    the record), the wrapper call's CUDA-event mean and the kernel's
    profiler device time over `reps` calls."""
    rows = []
    for rec in records:
        if "work" not in rec:
            rec["work"] = wave_work(scene, rec)
        fn = traverse_call(scene, rec)
        rows.append({"query": rec["kind"], "wave": rec["wave"],
                     "rows": rec["rows"], "call": rec["call"],
                     "ms": event_ms(fn, reps),
                     "kernel_ms": kernel_device_ms(fn, reps), **rec["work"]})
    return rows


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


def rendezvous_frames(device, poses=RENDEZVOUS_POSES):
    """(name, scene, camera, config) of poses of the rendezvous sequence
    (docs/RUN_RENDEZVOUS.md: the orbit CLI's --time 1 --dt 0.01 poses,
    the driver's textured detail-12 stand-in, camera and sun) at one of
    Run B's chunk launches (1920x1080, 129 of its 1000 spp)."""
    import dataclasses

    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.orbit import cli
    from dsrt_tpu_torch.render import fused_chunk_spp
    from dsrt_tpu_torch.utils.pose import read_pose_file
    from dsrt_tpu_torch.utils.timing import StageTimer
    from dsrt_tpu_torch.utils.transform import pose_to_frame
    tex = Path(__file__).resolve().parents[2] / "misc" / "iss_standin.png"
    args = driver.build_parser().parse_args(
        ["--standin_detail", "12", "--standin_tex", str(tex), "--width",
         "1920", "--height", "1080", "--spp", "1000"])
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(sys.stderr):
        txt = os.path.join(td, "poses.txt")
        cli.main(["--time", "1", "--dt", "0.01", "--device", device.type,
                  "--txt", txt])
        frames = [pose_to_frame(p) for p in read_pose_file(txt)]
        scene = driver.build_scene(args, StageTimer(), device)
    full = driver.render_config(args)
    cfg = dataclasses.replace(full, spp=fused_chunk_spp(full))
    for i in poses:
        f = frames[i]
        yield (f"rendezvous pose {i} ({f.separation_m:.1f} m)",
               *driver.frame_inputs(args, scene, f, device), cfg)


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


def load_records(path: Path, scene, cam, cfg, device) -> list:
    """The recorded waves and the 2^20 random rays, each with its work:
    from `path` when an earlier run saved them, else recorded (and
    saved)."""
    import torch
    if path.exists():
        records = torch.load(path, weights_only=False)
        for rec in records:
            for k in ("ro", "rd"):
                rec[k] = [c.to(device) for c in rec[k]]
            rec["active"] = rec["active"].to(device)
        return records
    records = record_waves(scene, cam, cfg) + random_records(device)
    for rec in records:
        rec["work"] = wave_work(scene, rec)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save([dict(r, ro=[c.cpu() for c in r["ro"]],
                     rd=[c.cpu() for c in r["rd"]],
                     active=r["active"].cpu()) for r in records], path)
    return records


def split_frame_walls(scene, cam, cfg, device, reps: int = 5) -> list:
    """The split frames of chip_smoke.py phase 11 (the stand-in, the mixed
    stand-in, the stand-in with fused_sun; 800x450 spp32 depth50
    spp_batch 4): least wall of `reps` frames, and one profiled frame's
    traversal kernel device time and device busy time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dsrt_tpu_torch.exec_opts import OPTS
    from dsrt_tpu_torch.models.mesh_gen import iss_mixed_scene
    from dsrt_tpu_torch.render import render_frame_wavefront
    mixed = iss_mixed_scene(detail=12, device=device)
    cases = (("stand-in", scene, False), ("mixed", mixed, False),
             ("stand-in fused_sun", scene, True))

    def frame(sc, fused):
        OPTS.fused_sun = fused
        try:
            render_frame_wavefront(sc, cam, cfg, spp_batch=4)
            torch.cuda.synchronize()
        finally:
            OPTS.fused_sun = False

    # every wall before any profiled frame
    rows = []
    for name, sc, fused in cases:
        frame(sc, fused)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            frame(sc, fused)
            walls.append((time.perf_counter() - t0) * 1e3)
        rows.append({"frame": name, "frame_ms": min(walls),
                     "frame_walls_ms": walls})
    for row, (_, sc, fused) in zip(rows, cases):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frame(sc, fused)
        trav = busy = 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if us <= 0 or getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            busy += us / 1e3
            if "traverse" in e.key:
                trav += us / 1e3
        row.update(traverse_device_ms=trav, device_busy_ms=busy)
    return rows


def traverse_main(dev, tree: str, card_name: str, args) -> int:
    """--traverse: the traversal kernels at the split frame's recorded
    waves and at 2^20 random rays, on both walks (the 8-ary walk, then
    the binary one that deeper trees take); with --frames the split
    frames' walls too."""
    import dataclasses

    from dsrt_tpu_torch.ops import traverse as tv
    scene, cam, cfg = split_frame(dev)
    records = load_records(Path(args.waves), scene, cam, cfg, dev)
    head = {"tree": tree, "card": card_name}
    if args.frames:
        # first, before any profiler session of this process
        for row in split_frame_walls(scene, cam, cfg, dev):
            print(json.dumps(dict(head, **row)), flush=True)
    print(json.dumps(dict(head, resources=traverse_resources())), flush=True)
    late = [r for r in records if r["wave"] == "late full width"]
    print(json.dumps(dict(head, launch_ops={
        r["kind"]: launch_ops(traverse_call(scene, r)) for r in late})),
        flush=True)
    walks = [("wide", scene), ("binary", dataclasses.replace(
        scene, wide_stack=tv.WIDE_STACK + 1))]
    for walk, sc in walks:
        for row in traverse_probe(sc, records, args.reps):
            print(json.dumps(dict(head, walk=walk, reps=args.reps, **row)),
                  flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--reps", type=int, default=10)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--cells", action="store_true")
    mode.add_argument("--sphere", action="store_true")
    mode.add_argument("--traverse", action="store_true")
    mode.add_argument("--rendezvous", action="store_true")
    ap.add_argument("--waves", default=str(Path(__file__).resolve()
                                           .parents[2] / "build"
                                           / "traverse_waves.pt"))
    ap.add_argument("--frames", action="store_true")
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
    if args.traverse:
        return traverse_main(dev, tree, name, args)
    if args.rendezvous:
        for cell, scene, cam, cfg in rendezvous_frames(dev):
            print(json.dumps({"tree": tree, "card": name, "cell": cell,
                              "shape": f"{cfg.width}x{cfg.height} "
                                       f"spp{cfg.spp}",
                              "kernel_ms": kernel_ms(scene, cam, cfg,
                                                     args.reps),
                              "reps": args.reps,
                              **tail_share(scene, cam, cfg)}), flush=True)
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
