"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dsrt_tpu_torch/csrc/, holds each against its
plain PyTorch version, renders the flagship frame (textured ISS stand-in,
51k triangles, 800x450, 32 spp, max_depth 50, sun on) through
`render_frame_fused`, runs the frame-loop driver over two poses, holds the
sphere kernel against its plain version on five sphere scenes, and renders
the two full-size sphere frames (rtiow 400x225 at 64 spp, volumetric
800x450 at 32 spp) through `render_frame_fused`.  Then the split pipeline
(phases 9-12): the traversal kernels (closest, any-hit and sun queries)
against their plain versions on 2^20 rays, on the 8-ary walk and on the
binary one that deeper trees take, on the stand-in and on the nested
triangles; their design phase (the kernels at the shapes the split waves
launch, recorded from a split frame, and at the 2^20 rays: active share,
node visits per query of both walks, bound, both walks' times,
registers and the device ops of a launch; tools/path_probe.py); the
wavefront and queue loops on the card against the same
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
share, longest pixel and per-phase cycle shares.  Then the rest of the
frame entry points (phases 15-18): both megakernels' pixel-list launch
against their frame launch at the same pixels, spp and salt (and
against the plain list version at 64x36); adaptive frames (the flagship
at cap 32, rtiow at cap 64) round by round, with each round's kernel
time and bound and its sums against the plain list version, and with every pixel run to the cap against the chunked
fixed frame; the debug render (both skies) against the plain walk and
the radiance against the path kernel's sums; the driver over four poses
of the flagship pipelined and serial (PNG bytes identical, wall per
frame of each), with --adaptive and with --debug_shade.  Then the
pipeline's two ends (phases 19-20): the RRDBNet-23 x4 upscaler on random
weights from a seed, on the flagship frame (tiles on the card against a
CPU copy of the module, x4 and x2; the whole frame's batched tiles
against one tile at a time; its time, peak memory and bound, and with
TF32 for the record), and the user's whole path: the orbit CLI on the
card (at its default span against the same CLI on the host, its Kepler
solve against NumPy's) and its poses through the driver with --upscale.
Each phase prints its lines; any failure raises, so the exit code is
nonzero.  The last two lines are the kernels' JSON summary and
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
# the list checks and adaptive frames (width, height, spp cap, samples a
# list launch and a round): the flagship on the path kernel, rtiow on the
# sphere kernel
LIST_FRAMES = {"dsrt_path_render": (800, 450, 32, 4),
               "dsrt_sphere_render": (400, 225, 64, 8)}
# the debug frames and the radiance check (width, height, spp), and the
# driver's frames of the pipeline phase
DEBUG_FRAME = (320, 180, 4)
RADIANCE_FRAME = (64, 36, 2)
PIPELINE_FRAME = (800, 450, 32)
# the upscaler phase: the seed of the random RRDBNet weights, the tile
# grid (dsrt_tpu_torch/models/esrgan.py defaults), TF32 dense peak of an
# H100 SXM; the whole-pipeline phase's orbit span and step [s]
ESRGAN_SEED = 0
ESRGAN_TILE = 128
ESRGAN_OVERLAP = 8
H100_TF32_FLOPS = 494.7e12
ORBIT_SPAN = ("1", "0.5")
# the orbit CLI's default span (--time 600 --dt 1) and the tolerances of
# its card path: pose components [m], eccentric anomaly [rad], position
# [km]
ORBIT_DEFAULT_SPAN = (600.0, 1.0)
ORBIT_POSE_TOL_M = 1e-3
KEPLER_TOL = (1e-12, 1e-6)


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
    the traversal kernel's as "traverse_kernel<Q,W>" (Q the query: 0
    closest, 1 any hit, 2 sun; W 1 for the 8-ary walk), the others by
    name."""
    import re
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            inst = re.search(r"path_render_kernelILj(\d+)E", mangled)
            walk = re.search(r"traverse_kernelILi(\d)ELb(\d)E", mangled)
            name = (f"path_render_kernel<{inst.group(1)}>" if inst else
                    f"traverse_kernel<{walk.group(1)},{walk.group(2)}>"
                    if walk else
                    "sphere_render_kernel" if "sphere_render_kernel" in
                    mangled else "sphere_list_kernel" if
                    "sphere_list_kernel" in mangled else mangled)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            regs[name] = int(m.group(1))
            name = None
    return regs


def walk_scenes(scene):
    """(walk, scene) pairs that take each walk of the traversal kernels:
    the scene itself (the 8-ary walk, its stack fits), and a copy that
    claims a stack deeper than the wide walk holds (the binary walk)."""
    from dsrt_tpu_torch.ops import traverse as tv
    deep = dataclasses.replace(scene, wide_stack=tv.WIDE_STACK + 1)
    out = [(tv.walk_of(scene), scene), (tv.walk_of(deep), deep)]
    require([w for w, _ in out] == list(tv.WALKS), "walk rule")
    return out


def nested_rays(n: int, seed: int, device):
    """Rays from near (0, 0, 2) into the nested triangles, most crossing
    dozens of them (numpy, from a seed)."""
    from dsrt_tpu_torch.ops.linalg import V3
    rng = np.random.default_rng(seed)
    o = np.zeros((3, n))
    o[0:2] = rng.normal(scale=0.3, size=(2, n))
    o[2] = 2.0
    d = rng.normal(scale=0.2, size=(3, n))
    d[2] = -1.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (V3(*(torch.from_numpy(c.astype(np.float32)).to(device)
                 for c in o)),
            V3(*(torch.from_numpy(c.astype(np.float32)).to(device)
                 for c in d)))


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
        # the plain version at the launched shape, once, against the kernel
        acc_kf, n_kf = sk.sphere_render(scene, cam, cfg)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        acc_pf, n_pf = sk.sphere_render_plain(scene, cam, cfg, spp)
        stop.record()
        torch.cuda.synchronize()
        p_full = start.elapsed_time(stop)
        err_f = float((acc_kf - acc_pf).abs().max())
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
              f"rays {int(n_k1)} vs {int(n_p1)}; at spp{spp}: plain "
              f"{p_full:.1f} ms, max |d| {err_f:.3g}, rays {int(n_kf)} vs "
              f"{int(n_pf)} (tolerance: identical); launches {launches}")
        require(torch.equal(acc_k1, acc_p1) and int(n_k1) == int(n_p1)
                and torch.equal(acc_kf, acc_pf) and int(n_kf) == int(n_pf),
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
                "plain_ms": p_full, "max_abs_err": err_f,
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


def traverse_design_phase(dev, stand) -> dict:
    """Phase "9 design": the traversal kernels at the shapes the split
    waves launch (the stand-in's split frame, 800x450 spp32 depth50
    spp_batch 4: its second full-width wave, its last full-width wave and
    its first drain wave, recorded as the frame runs) and at 2^20 random
    rays: active share, binary and wide node visits per query (a CPU
    sample), the bound from the binary walk's work, and the wrapper
    call's time (CUDA events) and the kernel's device time (profiler) of
    the kept 8-ary walk and of the binary walk in the same process; with
    registers, stack bytes and resident blocks of each instance and the
    device ops of one launch.  Returns each query's rows."""
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.tools import path_probe as pp
    t0 = time.perf_counter()
    _, cam, cfg = pp.split_frame(dev, stand)
    records = pp.record_waves(stand, cam, cfg) + pp.random_records(dev)
    for rec in records:
        rec["work"] = pp.wave_work(stand, rec, sample=1024)
    res = pp.traverse_resources()
    phase("9 design", "instances: " + "; ".join(
        f"{k} {v.get('registers', '?')} registers, {v.get('stack', '?')} "
        f"bytes stack, {v.get('spill', '?')} spilled, "
        f"{v.get('blocks_per_sm', '?')} blocks of 256 per SM"
        for k, v in sorted(res.items())))
    out = {q: {"instances": {k: v for k, v in res.items()
                             if k.startswith(q + "/")}, "shapes": []}
           for q in tv.QUERIES}
    for rec in records:
        w = rec["work"]
        row = {"wave": rec["wave"], "lanes": w["lanes"],
               "active_share": w["active_share"],
               "binary_visits_per_query": w["binary_per_query"],
               "wide_visits_per_query": w["wide_per_query"],
               "bound_ms": w["bound_ms"], "bound_by": w["bound_by"]}
        for walk, sc in walk_scenes(stand):
            fn = pp.traverse_call(sc, rec)
            row[walk] = {"ms": event_ms(fn, 10),
                         "kernel_ms": pp.kernel_device_ms(fn, 10)}
            require(row[walk]["kernel_ms"] > 0,
                    f"{rec['kind']} at {rec['wave']} ({walk} walk): no "
                    f"kernel time recorded")
        if rec["wave"] == "late full width":
            row["launch_ops"] = pp.launch_ops(pp.traverse_call(stand, rec))
            require(row["launch_ops"]["device_ops"] >= 1,
                    f"{rec['kind']} at {rec['wave']}: no device op recorded")
        phase("9 design",
              f"{rec['kind']} at {rec['wave']} ({w['lanes']} lanes, "
              f"{w['active_share']:.1%} active): visits per query binary "
              f"{w['binary_per_query']:.2f}, wide {w['wide_per_query']:.2f} "
              f"({w['sample']} sampled); bound {w['bound_ms']:.4f} ms by "
              f"{w['bound_by']}; wide walk {row['wide']['ms']:.4f} ms "
              f"(kernel {row['wide']['kernel_ms']:.4f}), binary walk "
              f"{row['binary']['ms']:.4f} ms (kernel "
              f"{row['binary']['kernel_ms']:.4f})"
              + (f"; one launch issues {row['launch_ops']['device_ops']} "
                 f"device ops ({', '.join(row['launch_ops']['device_names'])})"
                 if "launch_ops" in row else ""))
        out[rec["kind"]]["shapes"].append(row)
    phase("9 design", f"{time.perf_counter() - t0:.1f} s")
    return out


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
    from dsrt_tpu_torch.ops.shade import sun_direction
    from dsrt_tpu_torch.ops.trace import walk_counter
    from dsrt_tpu_torch.tools.path_probe import random_rays
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

    # 9. the traversal kernels against their plain versions, 2^20 rays,
    # on both walks, on the stand-in and on the nested triangles (a walk
    # that needs a deep stack)
    from dsrt_tpu_torch.models import feature_scenes as fs
    from dsrt_tpu_torch.models.materials import Material
    from dsrt_tpu_torch.models.scene import SceneBuilder
    tv.reset_launches()
    n = 1 << 20
    act = torch.from_numpy(np.random.default_rng(12).random(n) > 0.1).to(dev)
    nested = fs.nested_triangles(SceneBuilder, Material).build(device=dev)
    bias = 1e-3
    out = {}
    for sname, base, (ro, rd) in (
            ("stand-in", stand, random_rays(n, 11, dev)),
            ("nested triangles", nested, nested_rays(n, 13, dev))):
        sdir = sun_direction(base)

        def query_fn(sc, query, plain=False):
            if query == "sun":
                fn = tv.traverse_with_sun_plain if plain else \
                    tv.traverse_with_sun
                return lambda: fn(sc, ro, rd, act, 1e-3, 1e9, sdir, bias)
            fn = tv.traverse_plain if plain else tv.traverse
            return lambda: fn(sc, ro, rd, act, 1e-3, 1e9,
                              any_hit=query == "any")

        for query in tv.QUERIES:
            with walk_counter() as wc:
                want = query_fn(base, query, plain=True)()
            plain = (event_ms(query_fn(base, query, plain=True), 1)
                     if sname == "stand-in" else None)
            hitm = want[3] >= 0
            hits = int(hitm.sum())
            bound, by = tv.bound_ms(
                base, n, tv.ray_bytes(ro, rd, int(act.sum())),
                int(wc["visits"]), int(wc["tests"]), with_sun=query == "sun")
            for walk, sc in walk_scenes(base):
                got = query_fn(sc, query)()
                if query == "any":
                    mism, err = int(((got[3] >= 0) != hitm).sum()), 0.0
                else:
                    mism = int(((got[0] != want[0]) | (got[1] != want[1])
                                | (got[2] != want[2])
                                | (got[3] != want[3])).sum())
                    err = float((got[0] - want[0]).abs().max())
                bmism = (int((got[4] != want[4])[hitm].sum())
                         if query == "sun" else 0)
                ms = event_ms(query_fn(sc, query), 10)
                blocked = (f", {int(want[4][hitm].sum())} blocked, {bmism} "
                           f"mismatches in blocked on hit lanes"
                           if query == "sun" else "")
                phase("9 traverse",
                      f"{sname} {query} {walk} walk: 2^20 rays, "
                      f"{int(act.sum())} active, {hits} hits, {mism} "
                      f"mismatches ({'hit masks' if query == 'any' else '(t,u,v,tri)'}"
                      f"{blocked}; tolerance: none); kernel {ms:.3f} ms"
                      + (f", plain {plain:.1f} ms" if plain else "")
                      + f", bound {bound:.4f} ms by {by} (binary walk: "
                        f"{int(wc['visits'])} visits, {int(wc['tests'])} "
                        f"tests)")
                require(mism == 0 and bmism == 0 and hits > 1000,
                        f"{query} query ({walk} walk) disagrees with its "
                        f"plain version on the {sname}")
                if query == "sun":
                    require(0 < int(want[4][hitm].sum()) < hits,
                            f"sun query on the {sname}: no blocked mix")
                if sname == "stand-in":
                    out[(query, walk)] = dict(ms=ms, plain_ms=plain,
                                              max_abs_err=err, bound_ms=bound,
                                              bound_by=by)
    micro = dict(tv.INSTANCE_LAUNCHES)
    design = traverse_design_phase(dev, stand)
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
    split_launches = dict(tv.INSTANCE_LAUNCHES)
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
    for name, query, line in (("dsrt_traverse", "closest", 386),
                              ("dsrt_traverse any-hit", "any", 386),
                              ("dsrt_traverse_sun", "sun", 399)):
        e = out[(query, "wide")]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "dsrt_tpu_torch/csrc/traverse_kernel.cu",
            "replaces": f"dsrt_tpu/ops/pallas_trace.py:{line}",
            "launches": sum(split_launches[(query, w)] for w in tv.WALKS),
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None, "shape": "2^20 rays, 51k-triangle stand-in",
            "walk": "wide", "binary_walk_ms": out[(query, "binary")]["ms"],
            "launches_by_walk": {w: split_launches[(query, w)]
                                 for w in tv.WALKS},
            "launches_microbenchmark": sum(micro[(query, w)]
                                           for w in tv.WALKS),
            "design": design[query],
            "frames": {k: {"frame_ms": v["secs"] * 1e3, "rays": v["rays"],
                           "mrays_per_s": v["rays"] / v["secs"] / 1e6,
                           "kernel_device_ms": v["kernel_ms"],
                           "device_busy_ms": v["busy_ms"],
                           "profiled_wall_ms": v["wall_ms"],
                           "waves": v["waves"], "host_syncs": v["syncs"],
                           "host_ms": v["host"]}
                       for k, v in frames.items()}}
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


def list_cases(dev, flagship):
    """(kernel name, scene, camera, config, samples a launch, launch
    wrapper, plain version, 64x36 camera) of the list checks and adaptive
    frames (LIST_FRAMES): the flagship on the path kernel, rtiow on the
    sphere kernel."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    rt = presets.rtiow_smoke_scene(device=dev)
    out = []
    for name, scene, wrapper, plain in (
            ("dsrt_path_render", flagship, path_kernel.path_render,
             path_kernel.path_render_plain),
            ("dsrt_sphere_render", rt, sphere_kernel.sphere_render,
             sphere_kernel.sphere_render_plain)):
        w, h, cap, chunk = LIST_FRAMES[name]
        if name == "dsrt_path_render":
            cams = [point_camera_at(frm, vfov=40.0, width=cw, height=ch,
                                    device=dev)
                    for frm, cw, ch in ((BENCH_CAM, w, h),
                                        (SUNLIT_CAM, 64, 36))]
        else:
            cams = [make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=50,
                                width=cw, height=ch, device=dev)
                    for cw, ch in ((w, h), (64, 36))]
        out.append((name, scene, cams[0],
                    RenderConfig(width=w, height=h, spp=cap, max_depth=50),
                    chunk, wrapper, plain, cams[1]))
    return out


def list_check_phase(dev, flagship) -> dict:
    """Phase 15: each megakernel's pixel-list launch over a scattered
    ~30% of the frame, its complement and 300 pixels, against the
    full-frame launch at the same spp and salt (rows identical, rays of a
    set and its complement adding up to the frame's), and against the
    plain list version on the card on a 64x36 frame."""
    from dsrt_tpu_torch.render import SALT_MIX
    out = {}
    rng = np.random.default_rng(15)
    salt = (2 * SALT_MIX) & 0xFFFFFFFF
    for name, scene, cam, cfg, spp, launch, plain, cam_s in list_cases(
            dev, flagship):
        w, h = cfg.width, cfg.height
        npix = w * h
        full, n_full = launch(scene, cam, cfg, spp, salt)
        full = full.reshape(-1, 3)
        keep = rng.random(npix) < 0.3
        sets = {"30%": np.nonzero(keep)[0], "rest": np.nonzero(~keep)[0],
                "300": rng.permutation(npix)[:300]}
        rays = {}
        for k, idx in sets.items():
            pix = torch.as_tensor(idx, device=dev)
            acc, n = launch(scene, cam, cfg, spp, salt, pixels=pix)
            torch.cuda.synchronize()
            same = float((acc == full[pix]).all(-1).float().mean())
            require(torch.equal(acc, full[pix]),
                    f"{name}: the list launch over {k} differs from the "
                    f"frame launch ({same:.4%} of rows identical)")
            rays[k] = int(n)
        require(rays["30%"] + rays["rest"] == int(n_full),
                f"{name}: list rays do not add up to the frame's")
        pix30 = torch.as_tensor(sets["30%"], device=dev)
        ms_list = event_ms(lambda: launch(scene, cam, cfg, spp, salt,
                                          pixels=pix30), 5)
        ms_full = event_ms(lambda: launch(scene, cam, cfg, spp, salt), 5)
        # against the plain list version on the card, 64x36
        cfg_s = dataclasses.replace(cfg, width=64, height=36)
        small = torch.as_tensor(np.nonzero(rng.random(64 * 36) < 0.3)[0],
                                device=dev)
        acc_k, n_k = launch(scene, cam_s, cfg_s, spp, salt, pixels=small)
        acc_p, n_p = plain(scene, cam_s, cfg_s, spp, salt, pixels=small)
        torch.cuda.synchronize()
        phase("15 list check",
              f"{name} {w}x{h} spp{spp} salt {salt:#x}: list launches over "
              f"{len(sets['30%'])} (30%), {len(sets['rest'])} (the rest) and "
              f"300 scattered pixels: rows identical to the frame launch's, "
              f"rays {rays['30%']} + {rays['rest']} = {int(n_full)} (the "
              f"frame's); wrapper call (CUDA events) 30% list {ms_list:.3f} "
              f"ms, frame {ms_full:.3f} ms; 64x36 list of {small.numel()} vs "
              f"the plain list version on the card: identical "
              f"{torch.equal(acc_k, acc_p)}, rays {int(n_k)} vs {int(n_p)} "
              f"(tolerance: identical)")
        require(torch.equal(acc_k, acc_p) and int(n_k) == int(n_p),
                f"{name}: list launch and plain list version differ")
        require(float((acc_p > 0).float().mean()) > 0.05,
                f"{name}: the 64x36 list check is dark")
        out[name] = {"shape": f"{w}x{h} spp{spp}",
                     "pixels_30": len(sets["30%"]), "list_ms_30": ms_list,
                     "frame_ms": ms_full, "rays": rays,
                     "frame_rays": int(n_full)}
    return out


def record_rounds(run):
    """run() with every adaptive round's launch recorded: (result, list
    of (pixels, spp, salt, (n, 3) sums, ray count))."""
    from dsrt_tpu_torch import render
    launch = render.fused_accum
    rounds = []

    def recorded(scene, cam, cfg, spp, salt, pixels):
        acc, n = launch(scene, cam, cfg, spp, salt, pixels)
        rounds.append((pixels, spp, salt, acc, n))
        return acc, n

    render.fused_accum = recorded
    try:
        result = run()
    finally:
        render.fused_accum = launch
    torch.cuda.synchronize()
    return result, rounds


def round_work(name, scene, cam, cfg, pixels, spp, salt, rays,
               plain_too: bool):
    """roofline_ms of one list launch's work, and the plain list
    version's time on the card (CUDA events) and its (n, 3) sums and ray
    count on the same inputs (None unless `plain_too` or the bound needs
    the plain run: the path kernel's every round): the plain version's
    binary visits and triangle tests (path kernel) or the launch's rays
    times the sphere and medium tests (sphere kernel); the tables in,
    the list and the (n, 3) sums."""
    from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
    from dsrt_tpu_torch.ops.trace import walk_counter
    from dsrt_tpu_torch.ops.traverse import MT_FLOPS, SLAB_FLOPS, roofline_ms
    path = name == "dsrt_path_render"
    plain = (path_kernel.path_render_plain if path
             else sphere_kernel.sphere_render_plain)
    plain_ms = plain_out = None
    if path or plain_too:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with walk_counter() as wc:
            start.record()
            plain_out = plain(scene, cam, cfg, spp, salt, pixels)
            stop.record()
            torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
    if path:
        flops = int(wc["visits"]) * SLAB_FLOPS + int(wc["tests"]) * MT_FLOPS
        tables, extra = ("wide_pack", "tri_pack", "tri_shade", "mat_pack",
                         "tex_pool"), 0
    else:
        flops = rays * (SPHERE_FLOPS * scene.n_spheres
                        + MEDIUM_FLOPS * scene.n_media)
        tables, extra = ("mat_pack", "tex_pool"), 247 * 4
    bound, by = roofline_ms(flops, table_bytes(scene, tables) + extra
                            + pixels.numel() * 16)
    return bound, by, plain_ms, plain_out


def adaptive_phase(dev, flagship) -> dict:
    """Phase 16: adaptive frames (the flagship at cap 32, chunk 4; rtiow
    at cap 64, chunk 8; tol 0.02) through render_frame_adaptive, each
    round a list launch: rounds, mean spp, rays, frame wall, and per
    round the active pixels, the wrapper call's time (CUDA events), the
    kernel's device time (profiler) and the bound of its work; each
    round's sums and rays held identical to the plain list version on
    the round's own list (every round of the path kernel, the first and
    the last of the sphere kernel).  Then with a negative tol (no pixel converges; tol 0 stops pixels whose
    two bucket means are equal, as the black background's are) every
    pixel runs to the cap and each round's sums equal the full-frame
    launch of the matching chunk of render_accum_fused at a budget of one
    round, and their sum that function's."""
    from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
    from dsrt_tpu_torch.render import (render_accum_fused,
                                       render_frame_adaptive,
                                       render_frame_fused)
    counters = {"dsrt_path_render": path_kernel.LAUNCHES,
                "dsrt_sphere_render": sphere_kernel.LAUNCHES}
    out = {}
    for name, scene, cam, cfg, chunk, launch, _, _ in list_cases(dev,
                                                                 flagship):
        w, h, cap = cfg.width, cfg.height, cfg.spp
        run = lambda tol=0.02: render_frame_adaptive(  # noqa: E731
            scene, cam, cfg, tol=tol, chunk_spp=chunk, with_count=True)
        run()   # warm-up
        torch.cuda.synchronize()
        counters[name][name] = 0
        t0 = time.perf_counter()
        (img, stats), rounds = record_rounds(run)
        wall = time.perf_counter() - t0
        launches = counters[name][name]
        require(launches == stats["rounds"] and launches > 0,
                f"{name}: adaptive rounds did not launch the kernel")
        # the flagship view is mostly in shadow (phase 5: lit > 0)
        require(img.shape == (h, w, 3) and img.max() > 0,
                f"{name}: adaptive frame")
        secs, times, _ = wall_time(run, 2)
        kernel = ("path_render_kernel" if name == "dsrt_path_render"
                  else "sphere_list_kernel")
        per_round = []
        for i, (pixels, spp, salt, acc, n) in enumerate(rounds):
            fn = lambda: launch(scene, cam, cfg, spp, salt,  # noqa: E731
                                pixels=pixels)
            # the plain list version on the round's own list: every round
            # of the path kernel (its visits feed the bound), the first
            # and the last of the sphere kernel
            bound, by, plain_ms, plain_out = round_work(
                name, scene, cam, cfg, pixels, spp, salt, int(n),
                i in (0, len(rounds) - 1))
            if plain_out is not None:
                require(torch.equal(acc, plain_out[0])
                        and int(n) == int(plain_out[1]),
                        f"{name}: adaptive round {i} ({pixels.numel()} "
                        f"pixels) differs from the plain list version")
            per_round.append({"active": pixels.numel(), "spp": spp,
                              "rays": int(n), "ms": event_ms(fn, 3),
                              "kernel_ms": device_ms(fn, kernel, 3),
                              "bound_ms": bound, "bound_by": by,
                              "plain_ms": plain_ms,
                              "plain_identical": plain_out is not None})
        phase("16 adaptive",
              f"{name} {w}x{h} cap {cap} chunk {chunk} tol 0.02: "
              f"lit {(img > 0).mean():.4f}, {stats['rounds']} rounds, mean "
              f"spp {stats['mean_spp']:.3f}, "
              f"{stats['rays']} rays exact, {stats['samples']} samples; "
              f"rounds held identical (sums and rays) to the plain list "
              f"version on their lists: "
              f"{sum(r['plain_identical'] for r in per_round)} of "
              f"{len(per_round)}; frame wall {wall * 1e3:.1f} ms (first timed), least of 2 "
              f"{secs * 1e3:.1f} ms; launches {launches}; rounds (active "
              f"pixels: wrapper ms / kernel device ms / bound ms / plain "
              f"ms): "
              + ", ".join(f"{r['active']}: {r['ms']:.3f} / "
                          f"{r['kernel_ms']:.3f} / {r['bound_ms']:.4f} / "
                          + ("-" if r["plain_ms"] is None
                             else f"{r['plain_ms']:.0f}")
                          for r in per_round))
        if name == "dsrt_path_render":
            require(stats["mean_spp"] < cap,
                    "the flagship's adaptive frame ran every pixel to the "
                    "cap")
        # a negative tol: every pixel to the cap, the chunk schedule
        (img_all, st_all), rounds_all = record_rounds(lambda: run(-1.0))
        require(st_all["mean_spp"] == cap and
                st_all["rounds"] == -(-cap // chunk),
                f"{name}: tol -1 did not run every pixel to the cap")
        total = None
        for i, (pixels, spp, salt, acc, n) in enumerate(rounds_all):
            want, n_want = launch(scene, cam, cfg, spp, salt)
            require(torch.equal(acc, want.reshape(-1, 3))
                    and int(n) == int(n_want),
                    f"{name}: round {i} differs from its chunk launch")
            total = acc if total is None else total + acc
        chunked, n_chunked = render_accum_fused(scene, cam, cfg,
                                                budget=w * h * chunk)
        require(torch.equal(total, chunked.reshape(-1, 3))
                and st_all["rays"] == int(n_chunked),
                f"{name}: the rounds' sum differs from render_accum_fused")
        fixed = render_frame_fused(scene, cam, cfg, budget=w * h * chunk)
        same, mean_d = frame_compare(img_all, fixed)
        phase("16 adaptive",
              f"{name} tol -1: {st_all['rounds']} rounds, mean spp "
              f"{st_all['mean_spp']:.1f} (the cap), each round's sums "
              f"identical to the full-frame launch of its chunk, their sum "
              f"to render_accum_fused at budget {w * h * chunk}, rays "
              f"{st_all['rays']}; u8 against render_frame_fused at that "
              f"budget (float64 host sums against float32 device sums): "
              f"{same:.4%} identical, mean |d| {mean_d:.4f}")
        out[name] = {"shape": f"{w}x{h} cap {cap} chunk {chunk} tol 0.02",
                     "stats": stats, "frame_ms": secs * 1e3,
                     "launches": launches, "rounds": per_round,
                     "tol_minus_one": dict(st_all, identical_to_fused=same)}
    return out


def debug_phase(dev, scene) -> dict:
    """Phase 17: render_frame_debug on the textured stand-in (320x180
    spp 4, both skies) on the card (its walk the traversal kernel)
    against the same render with the plain walk on the card; and
    render_radiance (64x36 spp 2 depth 50) against path_render's sums x
    f32(1/spp), flipped."""
    from dsrt_tpu_torch import render
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.ops import path_kernel, traverse as tv
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.ops.trace import scene_hit
    w, h, spp = DEBUG_FRAME
    cam = point_camera_at(SUNLIT_CAM, vfov=40.0, width=w, height=h,
                          device=dev)
    out = {}
    for sky in ("solid", "gradient"):
        cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50,
                           sky_type=sky, sky_solid=(0.05, 0.05, 0.1))
        tv.reset_launches()
        t0 = time.perf_counter()
        img = render.render_frame_debug(scene, cam, cfg)
        secs = time.perf_counter() - t0
        launches = tv.LAUNCHES["dsrt_traverse"]
        walk = render.scene_hit_flat
        render.scene_hit_flat = scene_hit   # the plain walk, on the card
        try:
            img_p = render.render_frame_debug(scene, cam, cfg)
        finally:
            render.scene_hit_flat = walk
        same, mean_d = frame_compare(img, img_p)
        phase("17 debug",
              f"stand-in {w}x{h} spp{spp} sky {sky}: {secs * 1e3:.1f} ms, "
              f"dsrt_traverse launches {launches}; u8 against the plain walk "
              f"on the card {same:.4%} identical, mean |d| {mean_d:.4f} "
              f"(tolerance: >= 99% identical); lit {(img > 0).mean():.3f}")
        require(launches == cfg.spp, "the debug frame did not launch "
                                     "dsrt_traverse once a sample")
        require(same >= 0.99 and (img > 0).mean() > 0.05,
                f"debug frame ({sky} sky)")
        out[sky] = {"ms": secs * 1e3, "launches": launches,
                    "identical": same}
    w, h, spp = RADIANCE_FRAME
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
    cam_s = point_camera_at(SUNLIT_CAM, vfov=40.0, width=w, height=h,
                            device=dev)
    tv.reset_launches()
    rad = render.render_radiance(scene, cam_s, cfg)
    launches = tv.LAUNCHES["dsrt_traverse"]
    acc, _ = path_kernel.path_render(scene, cam_s, cfg)
    want = torch.flip(acc * float(np.float32(1.0 / cfg.spp)),
                      dims=[0]).cpu().numpy()
    err = float(np.abs(rad - want).max())
    same = float((rad == want).all(-1).mean())
    phase("17 radiance",
          f"stand-in {w}x{h} spp{spp} depth50: render_radiance (traversal "
          f"launches {launches}) against path_render's sums x f32(1/spp): "
          f"{same:.4%} of pixels identical, largest |d| {err:.3g} "
          f"(tolerance: >= 99% identical)")
    require(launches > 0 and same >= 0.99, "radiance")
    out["radiance"] = {"identical": same, "max_abs_err": err,
                       "launches": launches}
    return out


def pipeline_phase(dev, flagship) -> dict:
    """Phase 18: render_frame_async against render_frame_fused (u8
    identical: the tonemap on the card against the host's), then the
    driver over 4 poses of the flagship (800x450 spp32) pipelined and
    with --no_pipeline (PNG bytes identical; wall per frame of each),
    then with --adaptive 0.02 and with --debug_shade (exit 0, lit
    frames).  The driver's own lines go to a log file."""
    import contextlib
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.ops import path_kernel
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.render import (finish, render_frame_async,
                                       render_frame_fused)
    from dsrt_tpu_torch.utils.image_io import read_png
    from dsrt_tpu_torch.utils.pose import write_pose_file
    w, h, spp = PIPELINE_FRAME
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
    cam = point_camera_at(SUNLIT_CAM, vfov=cfg.vfov, width=w, height=h,
                          device=dev)
    img_a, n_a = finish(render_frame_async(flagship, cam, cfg))
    img_f, n_f = render_frame_fused(flagship, cam, cfg, with_count=True)
    phase("18 async frame",
          f"flagship {w}x{h} spp{spp}: render_frame_async (tonemap on the "
          f"card) against render_frame_fused (tonemap on the host): u8 "
          f"identical {np.array_equal(img_a, img_f)}, rays {n_a} vs {n_f}, "
          f"lit {(img_a > 0).mean():.4f} (tolerance: identical)")
    require(np.array_equal(img_a, img_f) and n_a == n_f
            and (img_a > 0).mean() > 0.05,
            "render_frame_async differs from render_frame_fused")
    poses = os.path.join(OUT, "poses4.txt")
    model = np.array([1.0e9, 1.5e9, 2.0e9])
    cams = np.array([BENCH_CAM, SUNLIT_CAM, (-60.0, 20.0, 150.0),
                     (120.0, -40.0, 140.0)])
    write_pose_file(poses, model + cams, np.stack([model] * 4), yaw=0.0)
    common = ["--input_txt", poses, "--wipe", "--width", str(w), "--height",
              str(h), "--spp", str(spp), "--device", dev.type]

    def drive(tag, *extra):
        out_dir = os.path.join(OUT, f"frames_{tag}")
        tsv = os.path.join(OUT, f"timings_{tag}.tsv")
        args = driver.build_parser().parse_args(
            common + ["--output_dir", out_dir, "--timings_tsv", tsv,
                      *extra])
        with open(os.path.join(OUT, f"driver_{tag}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            rc = driver.run(args, scene=flagship)
            wall = time.perf_counter() - t0
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        stages = {}
        with open(tsv) as fh:
            for ln in fh.readlines()[1:]:
                stage, ns, _ = ln.split("\t")
                stages.setdefault(stage, []).append(int(ns) / 1e6)
        return rc, wall, {p: open(os.path.join(out_dir, p), "rb").read()
                          for p in pngs}, stages, out_dir

    drive("warm", "--no_pipeline")
    runs = {}
    # serial and pipelined in turns, four pairs
    for k in range(4):
        for tag, extra in ((f"serial{k}", ["--no_pipeline"]),
                           (f"pipelined{k}", []))[::1 if k % 2 else -1]:
            path_kernel.reset_launches()
            rc, wall, pngs, stages, _ = drive(tag, *extra)
            require(rc == 0 and len(pngs) == 4, f"driver {tag}")
            runs[tag] = dict(
                wall_ms=wall * 1e3, per_frame_ms=wall * 1e3 / 4,
                encode_ms=stages.get("encode", []),
                render_ms=stages.get("render", []),
                launches=path_kernel.LAUNCHES["dsrt_path_render"], pngs=pngs)
    same = all(r["pngs"] == runs["serial0"]["pngs"] for r in runs.values())
    per_frame = {m: [runs[f"{m}{k}"]["per_frame_ms"] for k in range(4)]
                 for m in ("serial", "pipelined")}
    hidden = float(np.median(per_frame["serial"])
                   - np.median(per_frame["pipelined"]))
    serial = [runs[f"serial{k}"] for k in range(4)]
    phase("18 pipeline",
          f"flagship {w}x{h} spp{spp}, 4 poses, 4 runs each in turns: "
          f"wall per frame serial "
          f"{', '.join(f'{x:.2f}' for x in per_frame['serial'])} ms, "
          f"pipelined "
          f"{', '.join(f'{x:.2f}' for x in per_frame['pipelined'])} ms; "
          f"serial runs' render stage (frame issued to image on the host) "
          f"{np.median([x for r in serial for x in r['render_ms']]):.2f} "
          f"ms and encode "
          f"{np.median([x for r in serial for x in r['encode_ms']]):.2f} "
          f"ms a frame (medians); PNG bytes identical across the eight runs "
          f"{same}; the pipeline hid {hidden:.2f} ms a frame (median serial "
          f"minus median pipelined)")
    require(same, "pipelined and serial frames differ")
    require(all(r["launches"] >= 4 for r in runs.values()),
            "a driver run did not launch the path kernel")
    extras = {}
    for tag, extra in (("adaptive", ["--adaptive", "0.02"]),
                       ("debug", ["--debug_shade"])):
        rc, wall, pngs, stages, out_dir = drive(tag, *extra)
        lit = [float((read_png(os.path.join(out_dir, p)) > 0).mean())
               for p in pngs]
        phase("18 pipeline",
              f"--{tag if tag == 'adaptive' else 'debug_shade'}: rc {rc}, "
              f"{len(pngs)} frames, wall per frame {wall * 1e3 / 4:.1f} ms, "
              f"lit shares {', '.join(f'{x:.3f}' for x in lit)}")
        require(rc == 0 and len(pngs) == 4 and min(lit) > 0
                and max(lit) > 0.05, f"driver --{tag}")
        extras[tag] = {"per_frame_ms": wall * 1e3 / 4, "lit": lit}
    return {"runs": {t: {k: v for k, v in r.items() if k != "pngs"}
                     for t, r in runs.items()},
            "per_frame_ms": per_frame, "identical": same,
            "hidden_ms_per_frame": hidden, **extras}


def lively_params(rng, scale: int) -> dict:
    """RRDBNet-23 x`scale` parameters (num_feat 64, num_grow_ch 32): the
    model's init_params with weights x5 and N(0, 0.05) biases drawn from
    `rng` in the pytree's order.  init_params alone gives outputs of
    ~1e-4, so every u8 value would be 0."""
    from dsrt_tpu_torch.models import esrgan
    params = esrgan.init_params(rng, esrgan.rrdbnet_spec(scale=scale))

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w", "b"}:
                return {"w": node["w"] * np.float32(5),
                        "b": rng.normal(0.0, 0.05, node["b"].shape
                                        ).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]
    return walk(params)


def conv_work(net, h: int, w: int):
    """(FLOPs, bytes) of the network's convs on one (h, w) input: 2 per
    multiply-add, and each conv's float32 input read and output written
    once.  The trunk runs on the (unshuffled) input grid, conv_up1 on 4x
    its texels, conv_up2, conv_hr and conv_last on 16x."""
    unshuffle = {4: 1, 2: 2, 1: 4}[net.scale]
    grid = (h // unshuffle) * (w // unshuffle)
    up = {"conv_up1": 4, "conv_up2": 16, "conv_hr": 16, "conv_last": 16}
    flops = nbytes = 0
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            texels = grid * up.get(name, 1)
            flops += 2 * texels * m.in_channels * m.out_channels * 9
            nbytes += 4 * texels * (m.in_channels + m.out_channels)
    return flops, nbytes


def least_event_ms(fn, reps: int):
    """Least and all of `reps` CUDA-event times (ms) of single calls."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times), times


def u8_agreement(a, b):
    """(share of identical u8 values, max |d|)."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((d == 0).mean()), int(d.max())


def esrgan_phase(dev, frame: np.ndarray, card: str) -> dict:
    """Phase 19: RRDBNet-23 (num_feat 64, num_grow_ch 32) on random
    weights from ESRGAN_SEED, on the flagship frame of phase 5.  (a) The
    top-left tile and the most lit interior tile on the card against a
    CPU copy of the module; (b) the whole frame through upscale_u8 (tiles
    in batches) against the same tiles one at a time; (c) as (a) for the
    x2 model on the lit tile; (d) the whole frame's time (least of 3, CUDA
    events), peak memory, the bound from the convs' counted work, and the
    same call with cuDNN's TF32 on, for the record."""
    from unittest import mock
    from dsrt_tpu_torch.models import esrgan
    from dsrt_tpu_torch.ops.traverse import roofline_ms
    x = frame.astype(np.float32) / 255.0
    tiles, origins = esrgan.tile_grid(x, ESRGAN_TILE, ESRGAN_OVERLAP)
    ys = sorted({o[0] for o in origins})
    xs = sorted({o[1] for o in origins})
    inner = [i for i, (y0, x0) in enumerate(origins)
             if y0 not in (ys[0], ys[-1]) and x0 not in (xs[0], xs[-1])]
    lit = max(inner, key=lambda i: float((tiles[i] > 0).mean()))

    def to_u8(y):
        return np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)

    def tile_check(tag, scale, sel):
        params = lively_params(np.random.default_rng(ESRGAN_SEED), scale)
        net = esrgan.rrdbnet_from_params(params, scale, device=dev)
        card_out = esrgan.forward_tiles(net, tiles[sel])
        cpu_out = esrgan.forward_tiles(
            esrgan.rrdbnet_from_params(params, scale, device="cpu"),
            tiles[sel])
        rel = float(np.abs(card_out - cpu_out).max()
                    / np.abs(cpu_out).max())
        same, dmax = u8_agreement(to_u8(card_out), to_u8(cpu_out))
        u8 = to_u8(cpu_out)
        inside = float(((u8 > 0) & (u8 < 255)).mean())
        phase("19 esrgan",
              f"{card}; ({tag}) x{scale}, tiles "
              f"{', '.join(str(origins[i]) for i in sel)} (lit "
              f"{', '.join(f'{(tiles[i] > 0).mean():.3f}' for i in sel)}) "
              f"on the card against a CPU copy: float max |d| {rel:.3g} of "
              f"max |out|, u8 identical {same:.4%}, max |d| {dmax}, u8 "
              f"inside (0, 255) {inside:.1%} (tolerance: <= 1e-4, >= "
              f"99.9%, <= 1; >= 25% inside)")
        require(rel <= 1e-4 and same >= 0.999 and dmax <= 1
                and inside >= 0.25, f"RRDBNet x{scale} on the card "
                                    "disagrees with its CPU copy")
        return net, dict(rel_err=rel, u8_identical=same, u8_max_d=dmax,
                         inside=inside, tiles=[origins[i] for i in sel])

    net, check_a = tile_check("a", 4, [0, lit])
    # (b) the whole frame: batched tiles against one tile at a time
    batch = esrgan.tile_batch(net, ESRGAN_TILE, len(origins))
    whole = esrgan.upscale_u8(net, frame)
    h, w, _ = frame.shape
    singly = to_u8(esrgan.stitch(
        np.concatenate([esrgan.forward_tiles(net, t[None]) for t in tiles]),
        origins, h, w, ESRGAN_TILE, ESRGAN_OVERLAP))
    same_b, dmax_b = u8_agreement(whole, singly)
    phase("19 esrgan",
          f"{card}; (b) x4 {w}x{h} -> {whole.shape[1]}x{whole.shape[0]}, "
          f"{len(origins)} tiles of {ESRGAN_TILE} (overlap "
          f"{ESRGAN_OVERLAP}) in batches of {batch} against one at a time: "
          f"u8 identical {same_b:.4%}, max |d| {dmax_b} (tolerance: >= "
          f"99.9%, <= 1)")
    require(whole.shape == (4 * h, 4 * w, 3) and same_b >= 0.999
            and dmax_b <= 1, "batched tiles differ from single tiles")
    _, check_c = tile_check("c", 2, [lit])
    # (d) times, memory, bound; TF32 for the record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, times = least_event_ms(lambda: esrgan.upscale_u8(net, frame), 3)
    peak = torch.cuda.max_memory_allocated()
    fwd_ms, _ = least_event_ms(lambda: esrgan.forward_tiles(net, tiles), 3)
    flops, nbytes = conv_work(net, ESRGAN_TILE, ESRGAN_TILE)
    flops, nbytes = flops * len(origins), nbytes * len(origins)
    bound, bound_by = roofline_ms(flops, nbytes)
    bound_tf32 = max(flops / H100_TF32_FLOPS, nbytes / 3.35e12) * 1e3

    def tf32_convs():
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic,
                           allow_tf32=True)

    # the same call with its FP32 scope swapped for TF32
    with mock.patch.object(esrgan, "fp32_convs", tf32_convs):
        out_tf32 = esrgan.upscale_u8(net, frame)
        ms_tf32, times_tf32 = least_event_ms(
            lambda: esrgan.upscale_u8(net, frame), 3)
    same_t, dmax_t = u8_agreement(out_tf32, whole)
    phase("19 esrgan",
          f"{card}; (d) x4 {w}x{h} whole frame (upscale_u8, u8 in and out "
          f"on the host): {ms:.1f} ms (least of "
          f"{', '.join(f'{t:.1f}' for t in times)}), the {len(origins)} "
          f"tiles' forward alone {fwd_ms:.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB; bound {bound:.1f} ms by {bound_by} "
          f"({flops / 1e12:.2f} TFLOP at 67 TFLOP/s FP32, "
          f"{nbytes / 1e9:.1f} GB of conv activations at 3.35 TB/s; with "
          f"TF32 tensor cores {bound_tf32:.1f} ms); TF32 on (for the "
          f"record): {ms_tf32:.1f} ms, u8 identical to FP32 {same_t:.4%}, "
          f"max |d| {dmax_t}")
    return dict(card=card, check_a=check_a, check_c=check_c,
                batch=batch, batched_vs_single=dict(u8_identical=same_b,
                                                    u8_max_d=dmax_b),
                frame_ms=ms, frame_ms_all=times, forward_ms=fwd_ms,
                peak_bytes=peak, flops=flops, conv_bytes=nbytes,
                bound_ms=bound, bound_by=bound_by,
                bound_ms_tf32=bound_tf32, tf32_ms=ms_tf32,
                tf32_ms_all=times_tf32,
                tf32_vs_fp32=dict(u8_identical=same_t, u8_max_d=dmax_t))


def pipeline_ends_phase(dev, card: str) -> dict:
    """Phase 20: the user's whole path on the card.  The port's orbit CLI
    runs at its default span on the card and on the host, and the two
    pose files must agree; its Kepler solve on the card is held against
    the NumPy copies.  Then the CLI writes a short span's poses on the
    card and the driver renders them (the textured stand-in,
    PIPELINE_FRAME) with --upscale in a subprocess whose HOME caches a
    seeded RRDBNet-23 x4 checkpoint (basicsr keys under params_ema), so
    it takes the rrdbnet backend by its normal route."""
    from dsrt_tpu_torch.models import esrgan
    from dsrt_tpu_torch.models.mesh_gen import write_panel_texture
    from dsrt_tpu_torch.orbit import cli as orbit_cli
    from dsrt_tpu_torch.orbit import kepler, trajectory
    from dsrt_tpu_torch.utils.image_io import read_png
    from dsrt_tpu_torch.utils.pose import read_pose_file
    span, step = ORBIT_DEFAULT_SPAN
    # the Kepler solve on the card against NumPy's at the default span
    el = trajectory.OrbitElements()
    ang = [np.deg2rad(x) for x in (el.incl_deg, el.raan_deg, el.argp_deg)]
    M = np.sqrt(kepler.MU_MOON / el.a ** 3) * (-span + step * np.arange(
        int(round(span / step)) + 1))
    E = kepler.solve_kepler_E_torch(M, el.e, device=dev)
    f = kepler.true_anomaly_from_E_torch(E, el.e, device=dev)
    r = kepler.coe_to_rv_torch(el.a, el.e, *ang, f, device=dev)[0]
    E_ref = kepler.solve_kepler_E(M, el.e)
    r_ref = np.stack([kepler.coe_to_rv(el.a, el.e, *ang, fk)[0]
                      for fk in kepler.true_anomaly_from_E(E_ref, el.e)])
    dE = float(np.abs(E.cpu().numpy() - E_ref).max())
    dr = float(np.abs(r.cpu().numpy() - r_ref).max())
    # the CLI at its default span, on the card and on the host
    files, cli_s = {}, {}
    for where in (dev.type, "cpu"):
        files[where] = os.path.join(OUT, f"orbit_default_{where}.txt")
        t0 = time.perf_counter()
        rc = orbit_cli.main(["--device", where, "--txt", files[where]])
        cli_s[where] = time.perf_counter() - t0
        require(rc == 0, f"orbit CLI --device {where}")
    card_poses = np.loadtxt(files[dev.type])
    host_poses = np.loadtxt(files["cpu"])
    same_shape = card_poses.shape == host_poses.shape
    d_pose = (float(np.abs(card_poses - host_poses).max()) if same_shape
              else float("inf"))
    phase("20 pipeline",
          f"{card}; orbit CLI at its default span ({span:g} s at {step:g} "
          f"s): {len(card_poses)} poses on the card in "
          f"{cli_s[dev.type]:.3f} s, {len(host_poses)} on the host in "
          f"{cli_s['cpu']:.3f} s, pose max |d| {d_pose:.3e} m; Kepler on "
          f"the card against NumPy: E max |d| {dE:.3e} rad, r max |d| "
          f"{dr:.3e} km (tolerance: <= {ORBIT_POSE_TOL_M:g} m, "
          f"<= {KEPLER_TOL[0]:g} rad, <= {KEPLER_TOL[1]:g} km)")
    require(same_shape and len(card_poses) >= span / step - 10
            and d_pose <= ORBIT_POSE_TOL_M, "orbit CLI card vs host poses")
    require(dE <= KEPLER_TOL[0] and dr <= KEPLER_TOL[1],
            "Kepler solve on the card vs NumPy")
    w, h, spp = PIPELINE_FRAME
    poses = os.path.join(OUT, "orbit_poses.txt")
    rc_orbit = orbit_cli.main(["--time", ORBIT_SPAN[0], "--dt",
                               ORBIT_SPAN[1], "--device", dev.type,
                               "--txt", poses])
    n_poses = len(read_pose_file(poses))
    require(rc_orbit == 0 and n_poses >= 2, "orbit CLI poses")
    out_dir = os.path.join(OUT, "frames_orbit")
    tsv = os.path.join(OUT, "timings_orbit.tsv")
    with tempfile.TemporaryDirectory() as td:
        weights = os.path.join(td, ".cache", "realesrgan",
                               "RealESRGAN_x4plus.pth")
        os.makedirs(os.path.dirname(weights))
        torch.save({"params_ema": esrgan.state_dict_from_params(
            lively_params(np.random.default_rng(ESRGAN_SEED), 4))}, weights)
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex)
        env = dict(os.environ, HOME=td, PYTHONPATH=os.pathsep.join(
            filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dsrt_tpu_torch.driver", "--input_txt",
             poses, "--output_dir", out_dir, "--wipe", "--width", str(w),
             "--height", str(h), "--spp", str(spp), "--standin_detail",
             "12", "--standin_tex", tex, "--upscale", "--timings_tsv", tsv,
             "--device", dev.type], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
    with open(os.path.join(OUT, "driver_orbit.log"), "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    frames = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    up_dir = out_dir + "_upscaled"
    shapes = [read_png(os.path.join(up_dir, f)).shape
              for f in sorted(os.listdir(up_dir)) if f.endswith(".png")]
    stages = {}
    with open(tsv) as fh:
        for ln in fh.readlines()[1:]:
            stage, ns, _ = ln.split("\t")
            stages.setdefault(stage, []).append(int(ns) / 1e6)
    rrdbnet = "via rrdbnet" in proc.stdout
    phase("20 pipeline",
          f"{card}; orbit CLI on the card: {n_poses} poses; driver --upscale "
          f"{w}x{h} spp{spp} textured stand-in: rc {proc.returncode}, "
          f"{len(frames)} frames, backend rrdbnet {rrdbnet}, upscaled "
          f"{len(shapes)} PNGs {sorted(set(shapes))}; wall {wall:.1f} s "
          f"(process start to exit), render stage "
          f"{', '.join(f'{x:.1f}' for x in stages.get('render', []))} ms, "
          f"encode {', '.join(f'{x:.1f}' for x in stages.get('encode', []))}"
          f" ms, scene compile "
          f"{sum(stages.get('scene_compile', [])) / 1e3:.1f} s")
    require(proc.returncode == 0, "driver --upscale failed: "
            + proc.stderr[-2000:])
    require(rrdbnet and len(frames) == n_poses and len(shapes) == n_poses
            and all(s == (4 * h, 4 * w, 3) for s in shapes),
            "driver --upscale did not write 4x frames through the RRDBNet")
    return dict(card=card, poses=n_poses, wall_s=wall, stages_ms=stages,
                upscaled=len(shapes),
                orbit_default=dict(poses=len(card_poses), pose_max_d_m=d_pose,
                                   kepler_E_max_d=dE, kepler_r_max_d_km=dr,
                                   cli_s=cli_s))


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
    from dsrt_tpu_torch.tools.path_probe import random_rays

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

    # 3. closest hit: kernel vs the plain walk, 2^20 rays, exact, on the
    # 8-ary walk and on the binary one (a scene deeper than its stack)
    ro, rd = random_rays(1 << 20, 3, dev)
    act = torch.ones(ro.x.shape, dtype=torch.bool, device=dev)
    micro3 = traverse_launches["dsrt_traverse"]
    t_p = event_ms(lambda: lane_traverse(scene, ro, rd, 1e-3, 1e9, act), 1)
    hit_p = lane_traverse(scene, ro, rd, 1e-3, 1e9, act)
    hits = int((hit_p[3] >= 0).sum())
    for walk, sc in walk_scenes(scene):
        t_k = event_ms(lambda: traverse(sc, ro, rd, act, 1e-3, 1e9), 10)
        hit_k = traverse(sc, ro, rd, act, 1e-3, 1e9)
        mism = int(((hit_k[3] != hit_p[3]) | (hit_k[0] != hit_p[0])
                    | (hit_k[1] != hit_p[1]) | (hit_k[2] != hit_p[2])).sum())
        phase("3 closest hit", f"{walk} walk: 2^20 rays, {hits} hits, {mism} "
                               f"mismatches in (t,u,v,tri) (tolerance: "
                               f"exact); kernel {t_k:.3f} ms, plain "
                               f"{t_p:.1f} ms")
        require(mism == 0 and hits > 0, f"closest-hit kernel ({walk} walk) "
                                        "disagrees")
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
    # 15-18: the pixel-list launches, adaptive frames, the debug and
    # radiance renders, the pipelined driver
    t0 = time.perf_counter()
    lists = list_check_phase(dev, scene)
    adaptive = adaptive_phase(dev, scene)
    debug = debug_phase(dev, scene)
    pipeline = pipeline_phase(dev, scene)
    phase("15-18", f"{time.perf_counter() - t0:.0f} s")
    # 19-20: the pipeline's two ends, the upscaler and the pose generator
    t0 = time.perf_counter()
    ends = {"esrgan": esrgan_phase(dev, img, card),
            "pipeline": pipeline_ends_phase(dev, card)}
    with open(os.path.join(OUT, "pipeline_ends.json"), "w") as fh:
        json.dump(ends, fh, indent=1)
    phase("19-20", f"{time.perf_counter() - t0:.0f} s")
    # phase 3's launches are microbenchmark launches too; phases 5 and 14
    # (the megakernels' frames, --mode auto's path) required that no
    # traversal kernel was launched
    kernels["dsrt_traverse"]["launches_microbenchmark"] += micro3
    for walk_kernel in ("dsrt_traverse", "dsrt_traverse any-hit",
                        "dsrt_traverse_sun"):
        kernels[walk_kernel]["launches_main_path"] = 0
    entry = kernels["dsrt_path_render"]
    entry["frames"] = mixed
    entry["launches_by_frame"] = dict(
        {"flagship": entry["launches"]},
        **{k: v["launches"] for k, v in mixed.items()},
        **{"adaptive flagship": adaptive["dsrt_path_render"]["launches"],
           "pipelined driver, 4 frames":
               pipeline["runs"]["pipelined0"]["launches"]})
    entry["launches"] = sum(entry["launches_by_frame"].values())
    entry["pipeline"] = pipeline
    sph = kernels["dsrt_sphere_render"]
    sph["launches_by_frame"]["adaptive rtiow"] = \
        adaptive["dsrt_sphere_render"]["launches"]
    sph["launches"] = sum(sph["launches_by_frame"].values())
    for kname in ("dsrt_path_render", "dsrt_sphere_render"):
        kernels[kname]["list_launch"] = dict(check=lists[kname],
                                             adaptive=adaptive[kname])
    trav = kernels["dsrt_traverse"]
    trav["launches_by_path"] = {
        "split frames": trav["launches"],
        "debug frames": sum(debug[k]["launches"]
                            for k in ("solid", "gradient")),
        "radiance": debug["radiance"]["launches"]}
    trav["launches"] = sum(trav["launches_by_path"].values())
    trav["debug"] = debug

    require("jax" not in sys.modules, "jax was imported")
    require(not [m for m in sys.modules
                 if m == "dsrt_tpu" or m.startswith("dsrt_tpu.")],
            "the JAX package was imported")
    phase("done", f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
