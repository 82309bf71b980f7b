"""Measurements of the path kernel's design that its timings cannot give.

- `tail_share`: per-thread start and end stamps (`%globaltimer`, `%smid`)
  from a stamped copy of the kernel, built from a patched copy of
  csrc/ in a temporary directory, never in the source tree; from them
  the share of the kernel's window in which fewer than all SMs have
  work.  The patch anchors on the kernel's signature line and on its
  last statement (the ray count's atomicAdd), so it applies to this
  tree's kernel and to an earlier one alike.  Where the kernel renders
  a pixel by a call `render_pixel<M>(a, x, y, rays)`, each pixel's own
  start and end are stamped too: the longest pixel, whose samples run
  in order in one thread, is a floor under the frame's time.
- `visits_per_query`: the queries of a plain frame, recorded as the
  plain renderer issues them, replayed through `wide_walk_plain`:
  binary and wide node visits per query.

    python3 dsrt_tpu_torch/tools/path_probe.py [--tree DIR] [--reps N]
                                               [--cells]

prints one JSON line for the flagship frame (800x450, 32 spp, max_depth
50) rendered by the `dsrt_tpu_torch` package of DIR (default: this
tree): the kernel's mean time over N launches (CUDA events), the tail
share and pixel times of one stamped launch, the card's name and power
limit; with --cells one more line, the kernel's time alone, for each of
the three mixed frames (the mixed stand-in and the volumetric mesh at
800x450, `mixed_scene` at 400x225, all 32 spp).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
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


def tail_share(scene, cam, cfg) -> dict:
    """Tail share of one launch of a stamped copy of this package's path
    kernel (`path_kernel.path_render` on a CUDA scene), and its pixel
    times where the kernel has a per-pixel call."""
    import torch

    from dsrt_tpu_torch.ops import build, path_kernel
    import ctypes
    saved = (build.CSRC, build.BUILD_DIR, build._lib, dict(build.build_info))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as td:
        csrc = Path(td) / "csrc"
        shutil.copytree(saved[0], csrc)
        _patch(csrc)
        build.CSRC, build.BUILD_DIR, build._lib = csrc, Path(td), None
        try:
            lib = build.load()
            lib.dsrt_probe_set.argtypes = [ctypes.c_void_p] * 2
            lib.dsrt_probe_set.restype = ctypes.c_int
            buf = torch.zeros(3 * MAX_THREADS, dtype=torch.int64,
                              device=scene.device)
            pix = torch.zeros(2 * cfg.width * cfg.height, dtype=torch.int64,
                              device=scene.device)
            build.check(lib, lib.dsrt_probe_set(buf.data_ptr(),
                                                pix.data_ptr()),
                        "dsrt_probe_set")
            path_kernel.path_render(scene, cam, cfg)   # warm-up
            torch.cuda.synchronize()
            buf.zero_()
            pix.zero_()
            path_kernel.path_render(scene, cam, cfg)
            torch.cuda.synchronize()
            stamps = buf.view(-1, 3).cpu().numpy()
            pixels = pix.view(-1, 2).cpu().numpy()
        finally:
            build.CSRC, build.BUILD_DIR, build._lib = saved[:3]
            build.build_info.clear()
            build.build_info.update(saved[3])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = tail_share_of(stamps, n_sms)
    start = int(stamps[stamps[:, 2] > 0, 1].astype(np.int64).min())
    return dict(out, **pixel_times_of(pixels, start))


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


def kernel_ms(scene, cam, cfg, reps: int) -> float:
    """Mean time of `reps` launches of the path kernel (CUDA events)."""
    import torch

    from dsrt_tpu_torch.ops import path_kernel
    path_kernel.path_render(scene, cam, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        path_kernel.path_render(scene, cam, cfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cells", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("path_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    tree, name = str(Path(args.tree).resolve()), card()
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
