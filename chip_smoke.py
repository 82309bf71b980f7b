"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dsrt_tpu_torch/csrc/, holds each against its
plain PyTorch version, renders the flagship frame (textured ISS stand-in,
51k triangles, 800x450, 32 spp, max_depth 50, sun on) through
`render_frame_fused`, runs the frame-loop driver over two poses, holds the
sphere kernel against its plain version on five sphere scenes, and renders
the two full-size sphere frames (rtiow 400x225 at 64 spp, volumetric
800x450 at 32 spp) through `render_frame_fused`.  Then the split pipeline
(phases 9-12): the two traversal kernels against their plain versions on
2^20 rays, the wavefront and queue loops on the card against the same
loops on CPU copies, the full-size split-path frames (the untextured 51k
stand-in and the mixed stand-in with three spheres, 800x450, 32 spp)
through `render_frame_wavefront`, and the driver in wavefront and auto
modes.  Then the path kernel's wider scope (phases 13-14): every
feature scene of the CPU frame tests (spheres, quads, area lights, media,
sky, procedural textures, smooth normals, lens, shutter) at 64x36 through
the kernel against the plain version on CPU copies, and three full-size
mixed frames (the mixed stand-in, `mixed_scene`, the volumetric mesh)
through `render_frame_fused`, which must launch the path kernel and no
traversal kernel.  The path kernel is held bit for bit against its plain
version on the card (accumulators and ray counts) in phases 4, 5, 13 and
14; phase 5 does so on the flagship frame at its launched shape (800x450,
32 spp) and bounds it from that frame's counted work, and the design
phase after it prints the kernel's time there, node visits per query of
the binary and the 8-ary walk, and the tail share of a stamped copy of
the kernel (dsrt_tpu_torch/tools/path_probe.py); the deep-stack phase
after it holds the path kernel bit for bit against its plain version on
two trees whose walk needs a deep stack (the nested triangles, above 64
entries; the 264k stand-in, at 64).  Before the sphere
phases, the exact-math phase tries every input the kernels give their
short exact cos and sin (csrc/exact_math.cuh) against
libdevice and the plain version's float64 calls; after them, the sphere
design phase prints the sphere kernel's registers, resident blocks, tail
share, longest pixel and per-phase cycle shares.  Each phase prints one
line; any failure raises, so the exit code is nonzero.  The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.  Needs one CUDA device; imports no JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SUNLIT_CAM = (-20.0, -30.0, -95.0)   # lights about half the frame
BENCH_CAM = (40.0, 60.0, 190.0)      # the flagship viewpoint
# full-size sphere frames (preset, width, height, spp; max_depth 50,
# camera (0, 0.6, 2) -> (0, 0, -1), vfov 50): the JAX package's BASELINE
# configs[1] and its volumetric bench cell
SPHERE_FRAMES = (("rtiow_smoke_scene", 400, 225, 64),
                 ("volumetric_scene", 800, 450, 32))
# float operations of one sphere test (oc, two dots, discriminant, sqrt,
# two roots, range compares) and one medium's boundary interval
SPHERE_FLOPS = 28
MEDIUM_FLOPS = 40
# one quad test (trace.py quad_pass): the plane's denominator and offset
# (2 dots, 10), the parallel test (2), a subtract and a divide, the range
# compares (2), the hit point (9), two crosses (18), two dots with w (10),
# four range compares and the side compare (5)
QUAD_FLOPS = 58
# full-size mixed frames (name, width, height, spp; max_depth 50): the
# JAX bench's iss50k_mixed_800x450_32spp, mixed_400x225_32spp and
# volumetric_mesh_800x450_32spp cells
MIXED_FRAMES = (("mixed stand-in", 800, 450, 32),
                ("mixed_scene", 400, 225, 32),
                ("volumetric mesh", 800, 450, 32))


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def wall_time(fn, reps: int):
    """Warm-up once, then `reps` synchronised wall times; returns (least,
    all, last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), times, out


def event_ms(fn, reps: int) -> float:
    """Mean device time of `fn` in ms over `reps` calls after a warm-up,
    between CUDA events."""
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


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time in ms per call of the kernels whose name holds
    `kernel`, from torch.profiler over `reps` calls after a warm-up.
    Unlike CUDA events around a wrapper call it leaves out the host's
    share of the call (argument packing, its device-to-host reads)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps


def table_bytes(scene, names) -> int:
    return sum(getattr(scene, k).numel() * getattr(scene, k).element_size()
               for k in names)


def register_counts(log: str) -> dict:
    """Registers per kernel from nvcc's -Xptxas -v output: the path
    kernel's instances as "path_render_kernel<M>" (M its template bits),
    the others by name."""
    import re
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            inst = re.search(r"path_render_kernelILj(\d+)E", mangled)
            name = (f"path_render_kernel<{inst.group(1)}>" if inst else
                    next((k for k in ("sphere_render_kernel",
                                      "traverse_sun_kernel",
                                      "traverse_kernelILb0",
                                      "traverse_kernelILb1")
                          if k in mangled), mangled))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            regs[name.replace("traverse_kernelILb0", "traverse_kernel<0>")
                 .replace("traverse_kernelILb1", "traverse_kernel<1>")] = \
                int(m.group(1))
            name = None
    return regs


def random_rays(n: int, seed: int, device):
    """Rays from a shell around the station: half aimed at it, half in
    random directions (numpy, from a seed)."""
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


def deep_stack_phase(dev, regs: dict) -> dict:
    """The path kernel on trees whose walk needs a deep stack: more than
    the 64 entries the kernel held before it took the TPU kernel's 256
    (the nested triangles) or exactly 64 (the detail-28 stand-in, 264k
    triangle references), 64x36 spp 2 depth 8, against the plain version
    on the card: identical accumulators and rays."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
    from dsrt_tpu_torch.models.scene import SceneBuilder
    from dsrt_tpu_torch.ops import path_kernel
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=8)
    out = {}
    for name in ("nested triangles", "stand-in detail 28"):
        t0 = time.perf_counter()
        if name == "nested triangles":
            scene = fs.nested_triangles(SceneBuilder, Material).build(
                device=dev)
            cam = make_camera((0.0, 0.0, 2.0), (0.0, 0.0, -1.0), vfov=50,
                              width=64, height=36, device=dev)
        else:
            scene = iss_standin_scene(detail=28, device="cpu").to(dev)
            cam = point_camera_at(SUNLIT_CAM, vfov=cfg.vfov, width=64,
                                  height=36, device=dev)
        built = time.perf_counter() - t0
        inst = path_kernel.instance_of(scene, cfg)
        acc_k, n_k = path_kernel.path_render(scene, cam, cfg)
        acc_p, n_p = path_kernel.path_render_plain(scene, cam, cfg, 2)
        torch.cuda.synchronize()
        same = float((acc_k == acc_p).all(-1).float().mean())
        lit = float((acc_p > 0).float().mean())
        phase("5 deep stack",
              f"{name}: {scene.n_tris} triangle references, wide_stack "
              f"{scene.wide_stack} (the kernel's stack "
              f"{path_kernel.WIDE_STACK}), built in {built:.1f} s; "
              f"instance {inst} "
              f"({regs.get(f'path_render_kernel<{inst}>', '?')} registers) "
              f"64x36 spp2 depth8: accumulators identical to the plain "
              f"version on the card on {same:.4%} of pixels, rays "
              f"{int(n_k)} vs {int(n_p)} (tolerance: identical); lit {lit:.2f}")
        require(torch.equal(acc_k, acc_p) and int(n_k) == int(n_p),
                f"path kernel and its plain version differ on {name}")
        require(lit > 0.05, f"{name} frame is dark")
        require(name != "nested triangles" or scene.wide_stack > 64,
                f"{name}: wide_stack {scene.wide_stack}, not above 64")
        out[name] = {"wide_stack": scene.wide_stack, "instance": inst,
                     "identical": same, "rays": int(n_k)}
    return out


def exact_math_phase(dev) -> dict:
    """Every input the kernels give their short exact math, on the card,
    against libdevice and the plain version's float64 calls."""
    from dsrt_tpu_torch.ops import exact_math
    out = {}
    for fn in exact_math.DOMAINS:
        t0 = time.perf_counter()
        r = exact_math.check(fn, dev)
        phase("7 exact math",
              f"{fn}: {r['inputs']} inputs (every input the kernels give "
              f"it), mismatches "
              f"{r['vs_libdevice']} vs libdevice's (float)op((double)x), "
              f"{r['vs_plain']} vs the plain version's f64_op (required: "
              f"0); {time.perf_counter() - t0:.1f} s")
        require(r["vs_libdevice"] == 0 and r["vs_plain"] == 0,
                f"exact {fn} differs from the float64 call")
        out[fn] = r
    return out


def sphere_cases():
    """(name, CPU scene, config extras, look-from, vfov) of the sphere
    scenes the kernel is checked on: the three presets, depth of field
    with motion blur and the sun, and an environment sky from a seed."""
    from dsrt_tpu_torch.models import presets
    env = np.random.default_rng(5).uniform(0.0, 2.0, (8, 16, 3))
    return [
        ("rtiow", presets.rtiow_smoke_scene(device="cpu"), {},
         (0.0, 0.6, 2.0), 50),
        ("sphere_light", presets.sphere_light_scene(device="cpu"), {},
         (0.0, 0.6, 2.0), 50),
        ("volumetric", presets.volumetric_scene(device="cpu"), {},
         (0.0, 0.6, 2.0), 50),
        ("dof_motion", presets.dof_motion_scene(sun=True, device="cpu"),
         dict(aperture=0.2, time0=0.2, time1=0.8), (0.0, 0.4, 1.2), 60),
        ("env", presets.env_sphere_scene(env.astype(np.float32),
                                         rotation_deg=30.0, scale=1.5,
                                         device="cpu"),
         {}, (0.0, 0.6, 2.0), 50)]


def sphere_phases(dev, regs: dict) -> dict:
    """Phases 7-8: the exact math, the sphere kernel against its plain
    version on five scenes, then the two full-size sphere frames through
    render_frame_fused and the kernel's design measurements there.
    Returns the kernel's entry of the JSON line."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.ops import sphere_kernel as sk
    from dsrt_tpu_torch.ops.camera import make_camera
    from dsrt_tpu_torch.ops.traverse import roofline_ms
    from dsrt_tpu_torch.render import render_frame_fused, tonemap
    from dsrt_tpu_torch.tools import path_probe

    exact = exact_math_phase(dev)
    # 7. kernel vs plain on the card (and the plain version on the CPU),
    # 64x36, 4 spp, max_depth 12: identical accumulators and ray counts
    for name, scene_cpu, extra, look, vfov in sphere_cases():
        cfg = RenderConfig(width=64, height=36, spp=4, max_depth=12, **extra)
        cam = make_camera(look, (0.0, 0.0, -1.0), vfov=vfov, width=64,
                          height=36, aperture=extra.get("aperture", 0.0),
                          device="cpu")
        scene, cam_d = scene_cpu.to(dev), cam.to(dev)
        acc_k, n_k = sk.sphere_render(scene, cam_d, cfg)
        acc_p, n_p = sk.sphere_render_plain(scene, cam_d, cfg, cfg.spp)
        acc_c, n_c = sk.sphere_render_plain(scene_cpu, cam, cfg, cfg.spp)
        torch.cuda.synchronize()
        same = float((acc_k == acc_p).all(dim=-1).float().mean())
        err = float((acc_k - acc_p).abs().max())
        img_k, img_c = tonemap(acc_k, cfg, 4), tonemap(acc_c, cfg, 4)
        d = np.abs(img_k.astype(int) - img_c.astype(int))
        same_c = float((d.max(-1) == 0).mean())
        phase("7 sphere check",
              f"{name} 64x36 spp4 depth12: kernel vs plain on the card "
              f"{same:.4%} pixels identical, max |d| {err:.3g}, rays "
              f"{int(n_k)} vs {int(n_p)} (tolerance: identical); u8 vs the "
              f"CPU plain version {same_c:.4%} identical, mean |d| "
              f"{d.mean():.4f}, rays {int(n_c)} (tolerance: >= 99%, mean <= "
              f"0.5 u8); lit {(img_k > 0).mean():.2f}")
        require(torch.equal(acc_k, acc_p) and int(n_k) == int(n_p),
                f"sphere kernel disagrees with its plain version on {name}")
        require(same_c >= 0.99 and d.mean() <= 0.5,
                f"sphere kernel disagrees with the CPU plain version on "
                f"{name}")
        require((img_k > 0).mean() > 0.05, f"{name} frame is dark")

    # 8. full size through the user entry point
    entry = None
    design, frames = {}, []
    for name, w, h, spp in SPHERE_FRAMES:
        cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
        scene = getattr(presets, name)(device=dev)
        cam = make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=50,
                          width=w, height=h, device=dev)
        sk.reset_launches()
        secs, times, (img, rays) = wall_time(
            lambda: render_frame_fused(scene, cam, cfg, with_count=True), 3)
        launches = sk.LAUNCHES["dsrt_sphere_render"]
        require(launches > 0, "sphere kernel not launched")
        require(img.shape == (h, w, 3) and (img > 0).mean() > 0.2,
                f"{name} full-size image")
        require(rays >= w * h * spp, "ray count below one per sample")
        k_full = event_ms(lambda: sk.sphere_render(scene, cam, cfg), 3)
        k_dev = device_ms(lambda: sk.sphere_render(scene, cam, cfg),
                          "sphere_render_kernel", 3)
        require(k_dev > 0, "the profiler saw no sphere kernel")
        _, busy, prof_wall, _ = profile_frame(
            lambda: render_frame_fused(scene, cam, cfg))
        # None when the profiler recorded no kernel in that frame
        idle = 1 - busy / prof_wall if busy > 0 else None
        cfg1 = dataclasses.replace(cfg, spp=1)
        k1 = event_ms(lambda: sk.sphere_render(scene, cam, cfg1), 10)
        p1 = event_ms(lambda: sk.sphere_render_plain(scene, cam, cfg1, 1), 1)
        acc_k1, n_k1 = sk.sphere_render(scene, cam, cfg1)
        acc_p1, n_p1 = sk.sphere_render_plain(scene, cam, cfg1, 1)
        err1 = float((acc_k1 - acc_p1).abs().max())
        # bound: every query tests every sphere and every medium (flops of
        # trace.py sphere_pass / boundary_interval); tables in, accum out
        bound, bound_by = roofline_ms(
            int(n_p1) * (SPHERE_FLOPS * scene.n_spheres
                         + MEDIUM_FLOPS * scene.n_media),
            table_bytes(scene, ("mat_pack", "tex_pool")) + 247 * 4
            + acc_p1.numel() * 4)
        # the same at the launched shape, from the frame's exact rays
        frame_bound, frame_bound_by = roofline_ms(
            rays * (SPHERE_FLOPS * scene.n_spheres
                    + MEDIUM_FLOPS * scene.n_media),
            table_bytes(scene, ("mat_pack", "tex_pool")) + 247 * 4
            + acc_p1.numel() * 4)
        phase("8 sphere frame",
              f"{name} {w}x{h} spp{spp} depth50: frame {secs:.4f} s (reps "
              f"{', '.join(f'{t:.4f}' for t in times)}), wrapper call "
              f"(CUDA events) {k_full:.3f} ms, kernel on the device "
              f"(profiler) {k_dev:.3f} ms, {rays} rays exact, "
              f"{rays / secs / 1e6:.2f} Mrays/s on the frame wall, "
              f"{rays / k_dev / 1e3:.1f} on the kernel, bound "
              f"{frame_bound:.4f} ms by {frame_bound_by}; frame wall minus "
              f"wrapper call {secs * 1e3 - k_full:.3f} ms, device idle "
              + (f"{idle:.1%}" if idle is not None else "not measured")
              + f" of a profiled frame ({prof_wall:.2f} ms); spp1 wrapper calls: "
              f"kernel {k1:.3f} ms, plain {p1:.1f} ms, max |d| {err1:.3g}, "
              f"rays {int(n_k1)} vs {int(n_p1)}; launches {launches}")
        require(torch.equal(acc_k1, acc_p1) and int(n_k1) == int(n_p1),
                f"sphere kernel and plain disagree at the {name} frame")
        entry = {
            "name": "dsrt_sphere_render", "route": "cuda",
            "source": "dsrt_tpu_torch/csrc/sphere_kernel.cu",
            "replaces": "dsrt_tpu/ops/pallas_sphere.py:88",
            "launches": launches, "max_abs_err": err1, "ms": k1,
            "plain_ms": p1, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "shape": f"{w}x{h} spp1 max_depth50",
            "frame_ms": secs * 1e3, "frame_wrapper_ms": k_full,
            "frame_device_ms": k_dev, "mrays_per_s": rays / secs / 1e6,
            "launches_by_frame": dict(
                (entry or {}).get("launches_by_frame", {}),
                **{name: launches}),
            "frames": dict((entry or {}).get("frames", {}), **{name: {
                "shape": f"{w}x{h} spp{spp} max_depth50",
                "frame_kernel_ms": k_full, "device_ms": k_dev,
                "bound_ms": frame_bound, "bound_by": frame_bound_by,
                "frame_ms": secs * 1e3, "rays": rays,
                "idle_share": idle,
                "launches": launches}})}
        frames.append((name, w, h, spp, scene, cam, cfg))
    # the design: registers, resident blocks, and from one launch of a
    # stamped copy (built once for both frames) the tail share, the
    # longest pixel and the share of each phase's cycles in the longest
    # 1% of pixels
    stamped = path_probe.sphere_tail_shares([f[4:] for f in frames])
    for (name, w, h, spp, scene, _, _), t in zip(frames, stamped):
        blocks = sk.occupancy(scene.mat_pack.shape[0])
        shares = ", ".join(f"{p} {v:.1%}"
                           for p, v in t["phase_share_longest"].items())
        phase("8 design",
              f"{name} {w}x{h} spp{spp}: sphere_render_kernel "
              f"{regs.get('sphere_render_kernel', '?')} registers, {blocks} "
              f"blocks of 128 resident per SM; tail share "
              f"{t['tail_share']:.2%} of a {t['window_ms']:.3f} ms window "
              f"(stamped copy), SM busy mean {t['sm_busy_mean']:.2%}; "
              f"longest pixel {t['pixel_max_ms']:.3f} ms, p99 "
              f"{t['pixel_p99_ms']:.3f} ms, median {t['pixel_p50_ms']:.3f} "
              f"ms; cycles in the longest {t['phase_pixels_longest']} "
              f"pixels: {shares}")
        design[name] = dict(t, registers=regs.get("sphere_render_kernel"),
                            blocks_per_sm=blocks)
    entry["launches"] = sum(entry["launches_by_frame"].values())
    entry.update(exact_math=exact, design=design)
    return entry


def frame_compare(img_k, img_c):
    """(share of identical u8 pixels, mean |d|) of two frames."""
    d = np.abs(img_k.astype(int) - img_c.astype(int))
    return float((d.max(-1) == 0).mean()), float(d.mean())


def count_syncs(fn) -> int:
    """Host-device synchronisations in one call of `fn`, as PyTorch's
    sync debug mode reports them (.item(), bool() of a CUDA tensor,
    nonzero, blocking copies)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_frame(fn):
    """One call of `fn` under torch.profiler: (device ms of the traversal
    kernels by name, device busy ms, host wall ms of the call, host ms
    inside the CUDA runtime's synchronising calls and kernel launches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, busy = {}, 0.0
    host = {"sync_ms": 0.0, "launch_ms": 0.0, "launches": 0}
    for e in prof.key_averages():
        if "Synchronize" in e.key:
            host["sync_ms"] += e.self_cpu_time_total / 1e3
        elif "LaunchKernel" in e.key:
            host["launch_ms"] += e.self_cpu_time_total / 1e3
            host["launches"] += e.count
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0 or getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        busy += us / 1e3
        for k in ("traverse_sun_kernel", "traverse_kernel"):
            if k in e.key:
                by_name[k] = by_name.get(k, 0.0) + us / 1e3
                break
    return by_name, busy, wall, host


def split_phases(dev, poses) -> dict:
    """Phases 9-12, the split pipeline.  Returns the traversal kernels'
    entries of the JSON line."""
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.exec_opts import OPTS
    from dsrt_tpu_torch.models.mesh_gen import (iss_mixed_scene,
                                                iss_standin_scene)
    from dsrt_tpu_torch.ops import path_kernel, traverse as tv, wavefront
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.ops.linalg import V3
    from dsrt_tpu_torch.ops.shade import sun_direction
    from dsrt_tpu_torch.ops.trace import walk_counter
    from dsrt_tpu_torch.render import (lane_layout, render_frame_queue,
                                       render_frame_wavefront, tonemap)
    from dsrt_tpu_torch.utils.pose import write_pose_file

    t0 = time.perf_counter()
    stand_cpu = iss_standin_scene(detail=12, device="cpu")
    mixed_cpu = iss_mixed_scene(detail=12, device="cpu")
    stand, mixed = stand_cpu.to(dev), mixed_cpu.to(dev)
    phase("split scenes",
          f"stand-in {stand.n_tris} triangles, mixed {mixed.n_tris} "
          f"triangles + {mixed.n_spheres} spheres, built in "
          f"{time.perf_counter() - t0:.1f} s")
    require(stand.n_tris > 50000 and mixed.n_spheres == 3, "split scenes")

    # 9. the traversal kernels against their plain versions, 2^20 rays
    tv.reset_launches()
    n = 1 << 20
    ro, rd = random_rays(n, 11, dev)
    act = torch.from_numpy(np.random.default_rng(12).random(n) > 0.1).to(dev)
    sdir = sun_direction(stand)
    bias = 1e-3
    out = {}
    for name, any_hit in (("dsrt_traverse", False), ("any_hit", True)):
        got = tv.traverse(stand, ro, rd, act, 1e-3, 1e9, any_hit=any_hit)
        with walk_counter() as wc:
            want = tv.traverse_plain(stand, ro, rd, act, 1e-3, 1e9,
                                     any_hit=any_hit)
        hits = int((want[3] >= 0).sum())
        if any_hit:
            mism = int(((got[3] >= 0) != (want[3] >= 0)).sum())
            err = 0.0
        else:
            mism = int(((got[0] != want[0]) | (got[1] != want[1])
                        | (got[2] != want[2]) | (got[3] != want[3])).sum())
            err = float((got[0] - want[0]).abs().max())
        ms = event_ms(lambda: tv.traverse(stand, ro, rd, act, 1e-3, 1e9,
                                          any_hit=any_hit), 10)
        plain = event_ms(lambda: tv.traverse_plain(stand, ro, rd, act, 1e-3,
                                                   1e9, any_hit=any_hit), 1)
        bound, by = tv.bound_ms(stand, n, int(wc["visits"]),
                                int(wc["tests"]))
        what = "hit masks" if any_hit else "(t,u,v,tri)"
        phase("9 traverse", f"{'any-hit' if any_hit else 'closest'}: 2^20 "
                            f"rays, {int(act.sum())} active, {hits} hits, "
                            f"{mism} mismatches ({what}; "
                            f"tolerance: none); kernel {ms:.3f} ms, plain "
                            f"{plain:.1f} ms, bound {bound:.4f} ms by {by} "
                            f"({int(wc['visits'])} visits, "
                            f"{int(wc['tests'])} tests)")
        require(mism == 0 and hits > 1000, f"dsrt_traverse ({name}) "
                                           "disagrees with its plain version")
        out[name] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                         bound_ms=bound, bound_by=by)
    got = tv.traverse_with_sun(stand, ro, rd, act, 1e-3, 1e9, sdir, bias)
    with walk_counter() as wc:
        want = tv.traverse_with_sun_plain(stand, ro, rd, act, 1e-3, 1e9,
                                          sdir, bias)
    hitm = want[3] >= 0
    mism = int(((got[0] != want[0]) | (got[1] != want[1])
                | (got[2] != want[2]) | (got[3] != want[3])).sum())
    bmism = int((got[4] != want[4])[hitm].sum())
    ms = event_ms(lambda: tv.traverse_with_sun(stand, ro, rd, act, 1e-3, 1e9,
                                               sdir, bias), 10)
    plain = event_ms(lambda: tv.traverse_with_sun_plain(
        stand, ro, rd, act, 1e-3, 1e9, sdir, bias), 1)
    bound, by = tv.bound_ms(stand, n, int(wc["visits"]), int(wc["tests"]),
                            with_sun=True)
    phase("9 traverse_sun", f"2^20 rays, {int(hitm.sum())} hits, "
                            f"{int(want[4][hitm].sum())} blocked; {mism} "
                            f"mismatches in (t,u,v,tri), {bmism} in blocked "
                            f"on hit lanes (tolerance: none); kernel "
                            f"{ms:.3f} ms, plain {plain:.1f} ms, bound "
                            f"{bound:.4f} ms by {by}")
    require(mism == 0 and bmism == 0 and 0 < int(want[4][hitm].sum())
            < int(hitm.sum()), "dsrt_traverse_sun disagrees with its "
                               "plain version")
    out["dsrt_traverse_sun"] = dict(ms=ms, plain_ms=plain,
                                    max_abs_err=float((got[0] - want[0])
                                                      .abs().max()),
                                    bound_ms=bound, bound_by=by)

    micro = dict(tv.LAUNCHES)
    # 10. the wave loops on the card against the same loops on CPU copies
    cfg_s = RenderConfig(width=64, height=36, spp=4, max_depth=12)
    cam_s = point_camera_at(SUNLIT_CAM, vfov=cfg_s.vfov, width=64,
                            height=36, device="cpu")
    small_cpu = {"flagship": stand_cpu,
                 "mixed": iss_mixed_scene(detail=2, device="cpu")}
    px, py, valid, _ = lane_layout(64, 36)
    B = 2
    lanes = [np.tile(a, (B, 1)) for a in (px, py, valid)]
    lanes.append(np.repeat(np.arange(B), px.shape[0])[:, None]
                 .repeat(1024, axis=1))
    cases = [(k, v, False) for k, v in small_cpu.items()]
    cases.append(("flagship", stand_cpu, True))
    for name, sc_cpu, fused in cases:
        OPTS.fused_sun = fused
        try:
            sc = sc_cpu.to(dev)
            tv.reset_launches()
            acc_k, n_k = wavefront.trace_accumulate(
                sc, cfg_s, cam_s, *(torch.as_tensor(a, device=dev)
                                    for a in lanes), cfg_s.spp // B)
            q_k, qn_k = wavefront.trace_queue(sc, cfg_s, cam_s, 64, 36,
                                              (4, 1024))
            q_k2, _ = wavefront.trace_queue(sc, cfg_s, cam_s, 64, 36,
                                            (4, 1024))
            torch.cuda.synchronize()
            launches = dict(tv.LAUNCHES)
            acc_c, n_c = wavefront.trace_accumulate(
                sc_cpu, cfg_s, cam_s, *(torch.as_tensor(a) for a in lanes),
                cfg_s.spp // B)
            q_c, qn_c = wavefront.trace_queue(sc_cpu, cfg_s, cam_s, 64, 36,
                                              (4, 1024))
        finally:
            OPTS.fused_sun = False
        k_img = torch.stack([c.cpu() for c in acc_k], -1).reshape(-1, 3)
        c_img = torch.stack(list(acc_c), -1).reshape(-1, 3)
        same_w = float((k_img == c_img).all(-1).float().mean())
        err_w = float((k_img - c_img).abs().max())
        qi_k = tonemap(q_k.reshape(36, 64, 3), cfg_s, 4)
        qi_c = tonemap(q_c.reshape(36, 64, 3), cfg_s, 4)
        same_q, mean_q = frame_compare(qi_k, qi_c)
        phase("10 wave loops", f"{name}{' fused_sun' if fused else ''} "
                               f"64x36 spp4 depth12: wavefront accumulators "
                               f"identical on {same_w:.4%} of lanes, max "
                               f"|d| {err_w:.3g}, rays {int(n_k)} vs CPU "
                               f"{int(n_c)}; queue u8 {same_q:.4%} "
                               f"identical, mean |d| {mean_q:.4f}, rays "
                               f"{int(qn_k)} vs {int(qn_c)}, two card runs "
                               f"bit-equal {torch.equal(q_k, q_k2)} "
                               f"(tolerance: >= 99% identical, mean <= 0.5 "
                               f"u8, rays equal); launches {launches}")
        require(same_w >= 0.99 and same_q >= 0.99 and mean_q <= 0.5,
                f"wave loops disagree with the CPU plain walk on {name}")
        require(int(n_k) == int(n_c) and int(qn_k) == int(qn_c),
                f"ray counts disagree on {name}")
        require(torch.equal(q_k, q_k2), "queue banking is not deterministic")
        require(launches["dsrt_traverse_sun" if fused else "dsrt_traverse"]
                > 0, "the wave loops launched no traversal kernel")

    # 11. full size through render_frame_wavefront (spp_batch 4)
    cfg = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    cam = point_camera_at(BENCH_CAM, vfov=cfg.vfov, width=800, height=450,
                          device=dev)
    tv.reset_launches()
    frames = {}
    for name, sc, fused in (("stand-in", stand, False),
                            ("mixed", mixed, False),
                            ("stand-in fused_sun", stand, True)):
        OPTS.fused_sun = fused
        try:
            before = dict(tv.LAUNCHES)
            secs, times, (img, rays) = wall_time(
                lambda: render_frame_wavefront(sc, cam, cfg, spp_batch=4,
                                               with_count=True), 3)
            by_name, busy, wall, host = profile_frame(
                lambda: render_frame_wavefront(sc, cam, cfg, spp_batch=4))
            launched = {k: v - before[k] for k, v in tv.LAUNCHES.items()}
            syncs = count_syncs(
                lambda: render_frame_wavefront(sc, cam, cfg, spp_batch=4))
        finally:
            OPTS.fused_sun = False
        # one traversal launch a query; two queries a wave unless fused
        waves = sum(launched.values()) / 5 / (1 if fused else 2)
        frames[name] = dict(secs=secs, rays=rays, launches=launched,
                            kernel_ms=by_name, busy_ms=busy, wall_ms=wall,
                            waves=waves, syncs=syncs, host=host)
        phase("11 split frame", f"{name} 800x450 spp32 depth50 spp_batch4: "
                                f"frame {secs:.4f} s (reps "
                                f"{', '.join(f'{t:.4f}' for t in times)}), "
                                f"{rays} rays exact, "
                                f"{rays / secs / 1e6:.2f} Mrays/s; launches "
                                f"{launched} (5 frames), {waves:.0f} waves "
                                f"a frame, {syncs} host syncs a frame "
                                f"({syncs / waves:.1f} a wave); profiled "
                                f"frame: wall {wall:.1f} ms, traversal "
                                f"kernels {by_name} ms, device busy "
                                f"{busy:.1f} ms, idle share "
                                f"{1 - busy / wall:.1%}, host in sync calls "
                                f"{host['sync_ms']:.1f} ms and in "
                                f"{host['launches']} kernel launches "
                                f"{host['launch_ms']:.1f} ms; "
                                f"host share a wave of the unprofiled "
                                f"frame {(secs * 1e3 - busy) / waves:.2f} ms")
        require(img.shape == (450, 800, 3) and img.max() > 0,
                f"{name} split frame")
        require(rays >= 800 * 450 * 32, "ray count below one per sample")
        require(sum(launched.values()) > 0, "no traversal launch")
    launches = dict(tv.LAUNCHES)
    require(launches["dsrt_traverse"] > 0 and launches["dsrt_traverse_sun"]
            > 0, "a traversal kernel was not launched by the split frames")
    t0 = time.perf_counter()
    img_q = render_frame_queue(stand, cam, cfg)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    phase("11 queue frame", f"stand-in 800x450 spp32 depth50: one "
                            f"render_frame_queue frame {t_q:.4f} s (first "
                            f"call), lit {(img_q > 0).mean():.3f}")
    require(img_q.shape == (450, 800, 3) and img_q.max() > 0, "queue frame")

    # 12. the driver: two poses in wavefront mode, the mixed scene in auto
    import contextlib
    import io
    frames_dir = os.path.join(OUT, "frames_split")
    before = dict(tv.LAUNCHES)
    rc = driver.main(["--input_txt", poses, "--output_dir", frames_dir,
                      "--wipe", "--width", "320", "--height", "180",
                      "--spp", "16", "--spp_batch", "4", "--standin_detail",
                      "12", "--mode", "wavefront", "--device", "cuda"])
    pngs = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    require(rc == 0 and len(pngs) == 2
            and tv.LAUNCHES["dsrt_traverse"] > before["dsrt_traverse"],
            "driver wavefront frames")
    one_pose = os.path.join(OUT, "pose1.txt")
    model = np.array([1.0e9, 1.5e9, 2.0e9])
    write_pose_file(one_pose, model + np.array([list(BENCH_CAM)]),
                    model[None], yaw=0.0)
    log = io.StringIO()
    mixed_dir = os.path.join(OUT, "frames_mixed")
    path_before = path_kernel.LAUNCHES["dsrt_path_render"]
    with contextlib.redirect_stdout(log):
        rc2 = driver.run(driver.build_parser().parse_args(
            ["--input_txt", one_pose, "--output_dir", mixed_dir, "--wipe",
             "--width", "320", "--height", "180", "--spp", "16",
             "--mode", "auto", "--device", "cuda"]), scene=mixed)
    chose = "render (fused on cuda)" in log.getvalue()
    path_launches = path_kernel.LAUNCHES["dsrt_path_render"] - path_before
    phase("12 driver", f"wavefront rc {rc}, frames {pngs}; mixed scene in "
                       f"auto mode rc {rc2}, chose fused {chose}, path "
                       f"kernel launches {path_launches}")
    require(rc2 == 0 and chose and path_launches > 0,
            "auto mode did not choose the path kernel for the mixed scene")

    entries = {}
    for name, src_name in (("dsrt_traverse", "dsrt_traverse"),
                           ("dsrt_traverse_sun", "dsrt_traverse_sun")):
        e = out[src_name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "dsrt_tpu_torch/csrc/traverse_kernel.cu",
            "replaces": ("dsrt_tpu/ops/pallas_trace.py:386"
                         if name == "dsrt_traverse"
                         else "dsrt_tpu/ops/pallas_trace.py:399"),
            "launches": launches[name], "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None, "shape": "2^20 rays, 51k-triangle stand-in",
            "launches_microbenchmark": micro[name],
            "frames": {k: {"frame_ms": v["secs"] * 1e3, "rays": v["rays"],
                           "mrays_per_s": v["rays"] / v["secs"] / 1e6,
                           "kernel_device_ms": v["kernel_ms"],
                           "device_busy_ms": v["busy_ms"],
                           "profiled_wall_ms": v["wall_ms"],
                           "waves": v["waves"], "host_syncs": v["syncs"],
                           "host_ms": v["host"]}
                       for k, v in frames.items()}}
    entries["dsrt_traverse"]["any_hit"] = out["any_hit"]
    return entries



def mixed_cases(tex_path: str):
    """(name, CPU scene, CPU camera, config extras) of the CPU frame
    tests' scenes (tests/test_torch_mixed_frames.py) at 64x36."""
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.mesh_gen import (iss_mixed_scene,
                                                iss_standin_mesh)
    from dsrt_tpu_torch.models.scene import SceneBuilder
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    out = []
    for name, (fn, frm, at, vfov, extra) in fs.CASES.items():
        out.append((name, fn(SceneBuilder, Material,
                             tex_path=tex_path).build(device="cpu"),
                    make_camera(frm, at, vfov=vfov, width=64, height=36,
                                aperture=extra.get("aperture", 0.0),
                                device="cpu"), extra))
    kw = dict(vfov=40.0, width=64, height=36, device="cpu")
    out.append(("mixed_preset", presets.mixed_scene(device="cpu"),
                make_camera((0, 0.8, 2.6), (0, 0.3, -1), vfov=50, width=64,
                            height=36, device="cpu"), {}))
    out.append(("mixed_standin", iss_mixed_scene(detail=2, device="cpu"),
                point_camera_at(SUNLIT_CAM, **kw), {}))
    out.append(("volumetric_mesh",
                fs.volumetric_mesh(SceneBuilder, Material,
                                   standin_mesh=iss_standin_mesh,
                                   detail=2).build(device="cpu"),
                point_camera_at(SUNLIT_CAM, **kw), {}))
    return out


def mixed_frame_scene(name: str, dev):
    """(scene, camera, config) of a full-size mixed frame on the card."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.mesh_gen import (iss_mixed_scene,
                                                iss_standin_mesh)
    from dsrt_tpu_torch.models.scene import SceneBuilder
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    _, w, h, spp = next(f for f in MIXED_FRAMES if f[0] == name)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
    if name == "mixed_scene":
        return (presets.mixed_scene(device=dev),
                make_camera((0, 0.8, 2.6), (0, 0.3, -1), vfov=50, width=w,
                            height=h, device=dev), cfg)
    scene = (iss_mixed_scene(detail=12, device=dev) if name ==
             "mixed stand-in" else
             fs.volumetric_mesh(SceneBuilder, Material,
                                standin_mesh=iss_standin_mesh,
                                detail=4).build(device=dev))
    return scene, point_camera_at(BENCH_CAM, vfov=cfg.vfov, width=w,
                                  height=h, device=dev), cfg


def mixed_phases(dev, regs: dict) -> dict:
    """Phases 13-14: the path kernel's wider scope.  Returns the mixed
    frames for the path kernel's entry of the JSON line."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models.mesh_gen import write_panel_texture
    from dsrt_tpu_torch.ops import path_kernel, traverse as tv
    from dsrt_tpu_torch.ops.trace import walk_counter
    from dsrt_tpu_torch.ops.traverse import (MT_FLOPS, SLAB_FLOPS,
                                             roofline_ms)
    from dsrt_tpu_torch.render import render_frame_fused, tonemap

    # 13. every feature scene: the kernel on the card against the plain
    # version on CPU copies (and on the card), 64x36, spp 2, depth 8
    with tempfile.TemporaryDirectory() as td:
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex, size=16)
        cases = mixed_cases(tex)
    for name, scene_cpu, cam_cpu, extra in cases:
        cfg = RenderConfig(width=64, height=36, spp=2, max_depth=8, **extra)
        scene, cam = scene_cpu.to(dev), cam_cpu.to(dev)
        acc_k, n_k = path_kernel.path_render(scene, cam, cfg)
        acc_d, n_d = path_kernel.path_render_plain(scene, cam, cfg, 2)
        acc_c, n_c = path_kernel.path_render_plain(scene_cpu, cam_cpu, cfg, 2)
        torch.cuda.synchronize()
        same, mean_d = frame_compare(tonemap(acc_k, cfg, 2),
                                     tonemap(acc_c, cfg, 2))
        exact = float((acc_k == acc_d).all(-1).float().mean())
        max_abs = float((acc_k.cpu() - acc_c).abs().max())
        n_k, n_c = int(n_k), int(n_c)
        inst = path_kernel.instance_of(scene, cfg)
        phase("13 mixed check",
              f"{name} (instance {inst}, "
              f"{regs.get(f'path_render_kernel<{inst}>', '?')} registers) "
              f"64x36 spp2 depth8: u8 vs the CPU plain version {same:.4%} "
              f"identical, mean |d| {mean_d:.4f}, accum max |d| "
              f"{max_abs:.3g}, rays {n_k} vs {n_c} (tolerance: >= 98% "
              f"identical, mean <= 1 u8, rays within 1%); accumulators "
              f"identical to the plain version on the card on {exact:.4%} "
              f"of pixels, rays {int(n_d)} (tolerance: identical); lit "
              f"{float((acc_c > 0).float().mean()):.2f}")
        require(same >= 0.98 and mean_d <= 1.0
                and abs(n_k - n_c) <= 0.01 * n_c,
                f"path kernel disagrees with the plain version on {name}")
        require(torch.equal(acc_k, acc_d) and n_k == int(n_d),
                f"path kernel and its plain version on the card differ on "
                f"{name}")
        require(float((acc_c > 0).float().mean()) > 0.01,
                f"{name} frame is dark")

    # 14. full size through render_frame_fused
    frames = {}
    for name, w, h, spp in MIXED_FRAMES:
        t0 = time.perf_counter()
        scene, cam, cfg = mixed_frame_scene(name, dev)
        built = time.perf_counter() - t0
        path_kernel.reset_launches()
        tv.reset_launches()
        secs, times, (img, rays) = wall_time(
            lambda: render_frame_fused(scene, cam, cfg, with_count=True), 3)
        launched = dict(path_kernel.LAUNCHES, **tv.LAUNCHES)
        require(launched["dsrt_path_render"] > 0, f"{name}: path kernel not "
                                                  "launched")
        require(launched["dsrt_traverse"] == 0
                and launched["dsrt_traverse_sun"] == 0,
                f"{name}: a traversal kernel was launched")
        require(img.shape == (h, w, 3) and img.max() > 0, f"{name} image")
        require(rays >= w * h * spp, "ray count below one per sample")
        k_full = event_ms(lambda: path_kernel.path_render(scene, cam, cfg), 3)
        cfg1 = dataclasses.replace(cfg, spp=1)
        k1 = event_ms(lambda: path_kernel.path_render(scene, cam, cfg1), 10)
        p1 = event_ms(lambda: path_kernel.path_render_plain(scene, cam, cfg1,
                                                            1), 1)
        acc_k1, n_k1 = path_kernel.path_render(scene, cam, cfg1)
        acc_p1, n_p1 = path_kernel.path_render_plain(scene, cam, cfg1, 1)
        # the work of the launched shape (spp 32), counted at spp 8 and
        # taken 4 times; the plain version's time at spp 8
        cfg8 = dataclasses.replace(cfg, spp=8)
        acc_k8, n_k8 = path_kernel.path_render(scene, cam, cfg8)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with walk_counter() as wc:
            start.record()
            acc_p8, n_p8 = path_kernel.path_render_plain(scene, cam, cfg8, 8)
            stop.record()
            torch.cuda.synchronize()
        p8 = start.elapsed_time(stop)
        counts = {k: int(v) for k, v in wc.items()}
        flops = 4 * (counts["visits"] * SLAB_FLOPS
                     + counts["tests"] * MT_FLOPS
                     + counts["spheres"] * SPHERE_FLOPS
                     + counts["quads"] * QUAD_FLOPS
                     + counts["media"] * MEDIUM_FLOPS)
        bound, bound_by = roofline_ms(
            flops, table_bytes(scene, ("wide_pack", "tri_pack", "tri_shade",
                                       "tri_aux", "mat_pack", "tex_pool"))
            + path_kernel.PARAM_LEN * 4 + acc_p8.numel() * 4)
        err1 = float((acc_k1 - acc_p1).abs().max())
        same1 = float((acc_k1 == acc_p1).all(dim=-1).float().mean())
        same8 = float((acc_k8 == acc_p8).all(dim=-1).float().mean())
        inst = path_kernel.instance_of(scene, cfg)
        phase("14 mixed frame",
              f"{name} {w}x{h} spp{spp} depth50 ({scene.n_tris} triangles, "
              f"{scene.n_spheres} spheres, {scene.n_quads} quads, "
              f"{scene.n_lights} lights, {scene.n_media} media; built in "
              f"{built:.1f} s; instance {inst}, "
              f"{regs.get(f'path_render_kernel<{inst}>', '?')} registers): "
              f"frame {secs:.4f} s (reps "
              f"{', '.join(f'{t:.4f}' for t in times)}), {rays} rays exact, "
              f"{rays / secs / 1e6:.2f} Mrays/s, launches {launched} (4 "
              f"frames); kernel alone {k_full:.3f} ms, bound {bound:.4f} ms "
              f"by {bound_by} (spp 8 work x 4: {counts}); spp8: plain "
              f"{p8:.1f} ms, accumulators identical on {same8:.4%} of "
              f"pixels, rays {int(n_k8)} vs {int(n_p8)}; spp1: kernel "
              f"{k1:.3f} ms, plain {p1:.1f} ms, accumulators identical on "
              f"{same1:.4%} of pixels, max |d| {err1:.3g}, rays {int(n_k1)} "
              f"vs {int(n_p1)} (tolerance: identical)")
        require(torch.equal(acc_k1, acc_p1) and int(n_k1) == int(n_p1)
                and torch.equal(acc_k8, acc_p8) and int(n_k8) == int(n_p8),
                f"kernel and plain disagree at the {name} frame")
        frames[name] = {
            "shape": f"{w}x{h} spp{spp} max_depth50", "instance": inst,
            "registers": regs.get(f"path_render_kernel<{inst}>"),
            "launches": launched["dsrt_path_render"],
            "frame_ms": secs * 1e3, "frame_kernel_ms": k_full, "rays": rays,
            "mrays_per_s": rays / secs / 1e6, "bound_ms": bound,
            "bound_by": bound_by, "bound_work": "spp 8 x 4",
            "work_spp8": counts, "plain_ms_spp8": p8, "ms_spp1": k1,
            "plain_ms_spp1": p1, "max_abs_err_spp1": err1}
    return frames


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                                write_panel_texture)
    from dsrt_tpu_torch.ops import build, path_kernel
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.ops.trace import lane_traverse, walk_counter
    from dsrt_tpu_torch.ops.traverse import LAUNCHES as traverse_launches
    from dsrt_tpu_torch.ops.traverse import (MT_FLOPS, SLAB_FLOPS,
                                             roofline_ms, traverse)
    from dsrt_tpu_torch.render import (render_frame, render_frame_fused,
                                       tonemap)

    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("1 card", f"{name}; torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}, devices "
                    f"{torch.cuda.device_count()}")

    # 2. build the kernels from csrc/
    t0 = time.perf_counter()
    build.load()
    regs = register_counts(build.build_info["log"])
    blocks = {m: path_kernel.occupancy(m)
              for m in range(path_kernel.N_INSTANCES)}
    phase("2 build", f"{time.perf_counter() - t0:.1f} s "
                     f"(nvcc {build.build_info['seconds']:.1f} s); registers "
                     + ", ".join(f"{k} {v}" for k, v in sorted(regs.items()))
                     + "; path kernel blocks of 128 threads resident per SM "
                     + ", ".join(f"<{m}> {b}" for m, b in blocks.items()))
    require(min(blocks.values()) >= 1, "a path kernel instance does not fit "
                                       "an SM")

    with tempfile.TemporaryDirectory() as td:
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex)
        t0 = time.perf_counter()
        scene_cpu = iss_standin_scene(detail=12, tex_path=tex, device="cpu")
    scene = scene_cpu.to(dev)
    require(scene.n_tris > 50000 and scene.has_image_tex, "flagship scene")
    phase("scene", f"{scene.n_tris} triangles, {scene.n_nodes} nodes, "
                   f"{scene.n_textures} texture, built in "
                   f"{time.perf_counter() - t0:.1f} s")
    kernels = {}

    # 3. closest hit: kernel vs the plain walk, 2^20 rays, exact
    ro, rd = random_rays(1 << 20, 3, dev)
    act = torch.ones(ro.x.shape, dtype=torch.bool, device=dev)
    micro3 = traverse_launches["dsrt_traverse"]
    t_k = event_ms(lambda: traverse(scene, ro, rd, act, 1e-3, 1e9), 10)
    t_p = event_ms(lambda: lane_traverse(scene, ro, rd, 1e-3, 1e9, act), 1)
    hit_k = traverse(scene, ro, rd, act, 1e-3, 1e9)
    hit_p = lane_traverse(scene, ro, rd, 1e-3, 1e9, act)
    mism = int(((hit_k[3] != hit_p[3]) | (hit_k[0] != hit_p[0])
                | (hit_k[1] != hit_p[1]) | (hit_k[2] != hit_p[2])).sum())
    hits = int((hit_k[3] >= 0).sum())
    phase("3 closest hit", f"2^20 rays, {hits} hits, {mism} mismatches in "
                           f"(t,u,v,tri) (tolerance: exact); kernel "
                           f"{t_k:.3f} ms, plain {t_p:.1f} ms")
    require(mism == 0 and hits > 0, "closest-hit kernel disagrees")
    micro3 = traverse_launches["dsrt_traverse"] - micro3

    # 4. frame check: the path kernel vs the plain renderer on CPU copies
    cfg_s = RenderConfig(width=64, height=36, spp=2, max_depth=8)
    cam_s = point_camera_at(SUNLIT_CAM, vfov=cfg_s.vfov, width=64,
                            height=36, device="cpu")
    acc_k, n_k = path_kernel.path_render(scene, cam_s.to(dev), cfg_s)
    img_k = tonemap(acc_k, cfg_s, cfg_s.spp)
    img_p, n_p = render_frame(scene_cpu, cam_s, cfg_s, with_count=True)
    acc_p, _ = path_kernel.path_render_plain(scene_cpu, cam_s, cfg_s,
                                             cfg_s.spp)
    acc_d, n_d = path_kernel.path_render_plain(scene, cam_s.to(dev), cfg_s,
                                               cfg_s.spp)
    exact = float((acc_k == acc_d).all(-1).float().mean())
    diff = np.abs(img_k.astype(int) - img_p.astype(int))
    same = float((diff.max(-1) == 0).mean())
    mean_d = float(diff.mean())
    n_k = int(n_k)
    max_abs = float((acc_k.cpu() - acc_p).abs().max())
    phase("4 frame check", f"64x36 spp2 depth8: {same:.4%} pixels identical,"
                           f" mean |d| {mean_d:.4f} u8, max |d| {diff.max()}"
                           f" u8, accum max |d| {max_abs:.3g}; rays kernel "
                           f"{n_k} plain {n_p} (tolerance: >= 98% identical,"
                           f" mean <= 1 u8, rays within 1%); accumulators "
                           f"identical to the plain version on the card on "
                           f"{exact:.4%} of pixels, rays {int(n_d)} "
                           f"(tolerance: identical)")
    require(same >= 0.98 and mean_d <= 1.0, "path kernel disagrees")
    require(torch.equal(acc_k, acc_d) and n_k == int(n_d),
            "path kernel and its plain version on the card differ")
    require(abs(n_k - n_p) <= 0.01 * n_p, "ray counts disagree")
    require((img_k > 0).mean() > 0.2, "sunlit frame is dark")

    # plain vs kernel time at the check frame, both on the card
    cam_d = cam_s.to(dev)
    t_plain = event_ms(lambda: path_kernel.path_render_plain(
        scene, cam_d, cfg_s, cfg_s.spp), 1)
    t_kern = event_ms(lambda: path_kernel.path_render(scene, cam_d, cfg_s),
                      10)
    phase("4 times", f"64x36 spp2 depth8 on the card: kernel "
                     f"{t_kern:.3f} ms, plain {t_plain:.1f} ms")

    # 5. the flagship frame through the user entry point
    cfg = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    cam = point_camera_at(BENCH_CAM, vfov=cfg.vfov, width=800, height=450,
                          device=dev)
    path_kernel.reset_launches()
    walks = sum(traverse_launches.values())
    secs, times, (img, rays) = wall_time(
        lambda: render_frame_fused(scene, cam, cfg, with_count=True), 3)
    launches = dict(path_kernel.LAUNCHES)
    require(sum(traverse_launches.values()) == walks,
            "the flagship frame launched a traversal kernel")
    phase("5 flagship", f"800x450 spp32 depth50: {secs:.4f} s (reps "
                        f"{', '.join(f'{t:.4f}' for t in times)}), {rays} "
                        f"rays exact, {rays / secs / 1e6:.2f} Mrays/s, "
                        f"launches {launches}")
    require(launches["dsrt_path_render"] > 0, "path kernel not launched")
    require(img.shape == (450, 800, 3) and img.max() > 0, "flagship image")
    require(rays >= 800 * 450 * 32, "ray count below one per sample")

    # the kernel alone at the launched shape (one launch a frame: 800x450
    # x 32 spp is under the dispatch budget) against the plain version on
    # the card, bit for bit; the bound from the work the plain version
    # counts on these inputs (binary walk visits and triangle tests, the
    # least work of the two walks), the tables the kernel reads in, the
    # accumulators out
    k32 = event_ms(lambda: path_kernel.path_render(scene, cam, cfg), 5)
    acc_k32, n_k32 = path_kernel.path_render(scene, cam, cfg)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with walk_counter() as wc:
        start.record()
        acc_p32, n_p32 = path_kernel.path_render_plain(scene, cam, cfg, 32)
        stop.record()
        torch.cuda.synchronize()
    p32 = start.elapsed_time(stop)
    kernel_tables = ("wide_pack", "tri_pack", "tri_shade", "mat_pack",
                     "tex_pool")
    bound, bound_by = roofline_ms(
        int(wc["visits"]) * SLAB_FLOPS + int(wc["tests"]) * MT_FLOPS,
        table_bytes(scene, kernel_tables) + acc_p32.numel() * 4)
    err32 = float((acc_k32 - acc_p32).abs().max())
    same32 = float((acc_k32 == acc_p32).all(dim=-1).float().mean())
    # the 1-spp probe of earlier runs
    cfg1 = dataclasses.replace(cfg, spp=1)
    k1 = event_ms(lambda: path_kernel.path_render(scene, cam, cfg1), 10)
    p1 = event_ms(lambda: path_kernel.path_render_plain(scene, cam, cfg1, 1),
                  1)
    acc_k1, n_k1 = path_kernel.path_render(scene, cam, cfg1)
    with walk_counter() as wc1:
        acc_p1, n_p1 = path_kernel.path_render_plain(scene, cam, cfg1, 1)
    bound1, _ = roofline_ms(
        int(wc1["visits"]) * SLAB_FLOPS + int(wc1["tests"]) * MT_FLOPS,
        table_bytes(scene, kernel_tables) + acc_p1.numel() * 4)
    phase("5 times", f"800x450 spp32 depth50: kernel {k32:.3f} ms "
                     f"({int(n_k32) / k32 / 1e3:.1f} Mrays/s), plain "
                     f"{p32:.1f} ms, accumulators identical on {same32:.4%} "
                     f"of pixels, max |d| {err32:.3g}, rays {int(n_k32)} vs "
                     f"{int(n_p32)} (tolerance: identical); bound "
                     f"{bound:.4f} ms by {bound_by} ({int(wc['visits'])} "
                     f"visits, {int(wc['tests'])} tests); spp1: kernel "
                     f"{k1:.3f} ms, plain {p1:.1f} ms, bound {bound1:.4f} ms, "
                     f"rays {int(n_k1)} vs {int(n_p1)}")
    require(torch.equal(acc_k32, acc_p32) and int(n_k32) == int(n_p32)
            and torch.equal(acc_k1, acc_p1) and int(n_k1) == int(n_p1),
            "kernel and plain disagree at the flagship frame")
    kernels["dsrt_path_render"] = {
        "name": "dsrt_path_render", "route": "cuda",
        "source": "dsrt_tpu_torch/csrc/path_kernel.cuh",
        "replaces": "dsrt_tpu/ops/pallas_path.py:477",
        "launches": launches["dsrt_path_render"],
        "max_abs_err": err32, "ms": k32, "plain_ms": p32, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": None,
        "shape": "800x450 spp32 max_depth50", "frame_ms": secs * 1e3,
        "frame_kernel_ms": k32, "mrays_per_s": rays / secs / 1e6,
        "ms_spp1": k1, "plain_ms_spp1": p1, "bound_ms_spp1": bound1,
        "work_spp32": {k: int(v) for k, v in wc.items()}}

    # the design: the kernel's time at the flagship frame, node visits per
    # query of the binary and the 8-ary walk (the queries of a small plain
    # frame on CPU copies, replayed through wide_walk_plain), and the
    # share of the kernel's window in which fewer than all SMs had work
    # (one launch of a stamped copy)
    from dsrt_tpu_torch.tools import path_probe
    tail = path_probe.tail_share(scene, cam, cfg)
    cfg_v = RenderConfig(width=64, height=36, spp=2, max_depth=50)
    visits = {}
    for view, frm in (("flagship", BENCH_CAM), ("sunlit", SUNLIT_CAM)):
        visits[view] = path_probe.visits_per_query(
            scene_cpu, point_camera_at(frm, vfov=cfg_v.vfov, width=64,
                                       height=36, device="cpu"), cfg_v)
        require(visits[view]["wide_tests"] == visits[view]["binary_tests"],
                "the wide walk tested other triangles than the binary walk")
    phase("5 design", f"flagship 800x450 spp32: kernel {k32:.3f} ms; node "
                      f"visits per query (64x36 spp2 depth50, CPU copies) "
                      + "; ".join(f"{v} view {c['queries']} queries: binary "
                                  f"{c['binary_per_query']:.2f}, wide "
                                  f"{c['wide_per_query']:.2f}"
                                  for v, c in visits.items())
                      + f"; tail share {tail['tail_share']:.2%} of a "
                        f"{tail['window_ms']:.3f} ms window (stamped copy), "
                        f"SM busy mean {tail['sm_busy_mean']:.2%}, min "
                        f"{tail['sm_busy_min']:.2%}, {tail['sms_seen']} of "
                        f"{tail['sms']} SMs; instance 0: "
                        f"{regs.get('path_render_kernel<0>', '?')} registers, "
                        f"{blocks[0]} blocks of 128 resident per SM")
    kernels["dsrt_path_render"].update(
        registers=regs.get("path_render_kernel<0>"),
        blocks_per_sm=blocks[0], tail=tail, visits_per_query=visits)
    kernels["dsrt_path_render"]["deep_stack"] = deep_stack_phase(dev, regs)

    # 6. the driver over two poses
    poses = os.path.join(OUT, "poses.txt")
    from dsrt_tpu_torch.utils.pose import write_pose_file
    model = np.array([1.0e9, 1.5e9, 2.0e9])   # Sun at the world origin
    write_pose_file(poses, model + np.array([[40.0, 60.0, 190.0],
                                             [-60.0, 20.0, 150.0]]),
                    np.stack([model, model]), yaw=0.0)
    frames = os.path.join(OUT, "frames")
    with tempfile.TemporaryDirectory() as td:
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex)
        rc = driver.main(["--input_txt", poses, "--output_dir", frames,
                          "--wipe", "--width", "320", "--height", "180",
                          "--spp", "16", "--standin_detail", "12",
                          "--standin_tex", tex, "--device", "cuda"])
    from dsrt_tpu_torch.utils.image_io import read_png
    pngs = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    lit = [float((read_png(os.path.join(frames, f)) > 0).mean())
           for f in pngs]
    phase("6 driver", f"rc {rc}, frames {pngs}, lit shares {lit}")
    require(rc == 0 and len(pngs) == 2 and min(lit) > 0, "driver frames")

    kernels["dsrt_sphere_render"] = sphere_phases(dev, regs)
    kernels.update(split_phases(dev, poses))
    mixed = mixed_phases(dev, regs)
    # phase 3's launches are microbenchmark launches too; phases 5 and 14
    # (the megakernels' frames, --mode auto's path) required that no
    # traversal kernel was launched
    kernels["dsrt_traverse"]["launches_microbenchmark"] += micro3
    for walk_kernel in ("dsrt_traverse", "dsrt_traverse_sun"):
        kernels[walk_kernel]["launches_main_path"] = 0
    entry = kernels["dsrt_path_render"]
    entry["frames"] = mixed
    entry["launches_by_frame"] = dict(
        {"flagship": entry["launches"]},
        **{k: v["launches"] for k, v in mixed.items()})
    entry["launches"] = sum(entry["launches_by_frame"].values())

    require("jax" not in sys.modules, "jax was imported")
    require(not [m for m in sys.modules
                 if m == "dsrt_tpu" or m.startswith("dsrt_tpu.")],
            "the JAX package was imported")
    phase("done", f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
