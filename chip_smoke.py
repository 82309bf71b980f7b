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
TF32 for the record), the dense blocks' conv kernel ("19 dense": each
block's output and the frame's u8 against its plain version on the card,
widths it does not take refused, a block's time against its bound, the
plain version and cuDNN with torch.cat, and the trunk's share of the
frame's device time), and the user's whole path: the orbit CLI on the
card (at its default span against the same CLI on the host, its Kepler
solve against NumPy's) and its poses through the driver with --upscale.
Then the sharded renders (phase 21, dsrt_tpu_torch/parallel/): a
1-rank NCCL mesh's flagship frame; two ranks sharing the card (gloo)
rendering the flagship and rtiow dp-sharded, one list launch a rank,
each rank's list launch timed and bounded, and the sharded call and its
gather timed; the same ranks rendering the flagship at sp = 2 through
the traversal kernels against the single-process slice emulation
through the plain walk, with the kernels timed, bounded and held
against the plain walk at that frame's own waves; the driver under
torch.distributed.run with --shard and as two --hosts processes against
phase 6's PNGs.  Then the rendezvous sequence of docs/RUN_RENDEZVOUS.md
(phase 22): the orbit CLI on the card writes its 99 poses (--time 1 --dt
0.01, 1787 m to 36 m from the station); the driver renders all of them
as Run A (the textured detail-12 stand-in, 800x450, 250 spp, --mode
auto: one path kernel launch a frame) and poses 0, 49 and 98 as Run B
(1920x1080, 1000 spp: eight salted chunk launches a frame, each frame
u8- and ray-identical to render_accum_fused on the driver's scene,
camera and sun), with the per-frame render stage, rays and Mrays/s of
both (tools/sequence_stats.py); one salted chunk launch of each Run B
frame and Run A's launch at pose 49 equal the plain version (on CPU
copies) at their own shapes over a list of their lit pixels and
uniformly drawn ones; the frames against the JAX package's frames of the same runs over
their lit pixels; at poses 49 and 98 (160x90, 4 spp) render_frame_fused
equals the path kernel's plain version on the card, whose counted work
bounds the kernel at the sequence's frames; the driver's issue path
(`frame_inputs`, `render_frame_async`) over two poses at Run A's and
Run B's settings (one launch a frame, and 8) makes no host-device
synchronisation.
Each phase prints its lines; any failure raises, so the exit code is
nonzero.  The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.  Needs one CUDA device; imports no JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import signal
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
# the dense blocks' conv kernel: its FP32 peak, the batch of images (h, w)
# that its checks run on (edge tiles both ways, padding per image), and
# the tile batch of the rdv_a_x4 cell (800x450 on the 128 / 8 grid)
H100_FP32_FLOPS = 67e12
DENSE_CHECK = (3, 90, 100)
DENSE_TILES = 28
ORBIT_SPAN = ("1", "0.5")
# the orbit CLI's default span (--time 600 --dt 1) and the tolerances of
# its card path: pose components [m], eccentric anomaly [rad], position
# [km]
ORBIT_DEFAULT_SPAN = (600.0, 1.0)
ORBIT_POSE_TOL_M = 1e-3
KEPLER_TOL = (1e-12, 1e-6)
# the tables the path kernel reads (its bound's bytes)
PATH_TABLES = ("wide_pack", "tri_pack", "tri_shade", "mat_pack", "tex_pool")
# the sharded phase: ranks sharing the card (dp of the megakernel frames,
# sp of the flagship's sample slices), the timed repetitions, and each
# group of rank processes' time limit [s]
SHARD_DP = 2
SHARD_REPS = 5
SHARD_TIMEOUT = 600
# the rendezvous phase (docs/RUN_RENDEZVOUS.md): the orbit CLI's span and
# step [s] and its pose count; Run A's and Run B's frames (width, height,
# spp), Run B on the doc's sample poses; the path kernel against its
# plain version at two of the sequence's poses (width, height, spp)
RDV_SPAN = ("1", "0.01")
RDV_POSES = 99
RDV_RUN_A = (800, 450, 250)
RDV_RUN_B = (1920, 1080, 1000)
RDV_SAMPLES = (0, 49, 98)
RDV_CHECK = (160, 90, 4)
RDV_CHECK_POSES = (49, 98)
RDV_TEX = os.path.join(ROOT, "misc", "iss_standin.png")
# the launches held against the plain version at their own shapes: for
# each Run B sample pose the chunk (its index in the frame's schedule:
# 129 spp under a nonzero salt, the last one 97 spp), and Run A's launch
# at one pose; the pixels listed for the plain version (at most this
# many of the launch's lit pixels, this many drawn uniformly) and the
# seed of the draw
RDV_CHUNKS = (1, 4, 7)
# the issue path's synchronisations are counted over two of the close
# poses on a frame of this size (width, height), at Run A's spp in one
# launch a frame and at Run B's in launches of this many primary rays
# (8 salted chunks a frame, as Run B's frames)
RDV_SYNC_POSES = (93, 94)
RDV_SYNC_FRAME = (160, 90)
RDV_SYNC_RUN_B_RAYS = 160 * 90 * 125
RDV_A_POSE = 49
RDV_PIXELS = (768, 256)
RDV_PIXEL_SEED = 22
# the JAX package's frames of the same runs (docs/RUN_RENDEZVOUS.md):
# Run A's and Run B's PNG of each pose, compared over the pixels lit in
# either frame: the lit counts within RDV_LIT_COUNT of each other and the
# mean signed difference within RDV_BIAS_U8 (the JAX frames come from
# the TPU, whose float operations send some samples of a far pose's
# sub-pixel geometry down other paths); where at least RDV_FULL of the
# frame is lit, also >= 99% of those pixels identical and mean |d| <=
# 0.5 u8
RDV_REFERENCE = {("A", 0): "rendezvous250_frame_0000.png",
                 ("A", 98): "rendezvous250_frame_0098.png",
                 ("B", 0): "rendezvous1080_frame_0000.png",
                 ("B", 49): "rendezvous1080_frame_0049.png",
                 ("B", 98): "rendezvous1080_frame_0098.png"}
RDV_LIT_COUNT = 0.1
RDV_BIAS_U8 = 1.0
RDV_FULL = 0.01


def phase(name: str, msg: str) -> None:
    """Print a phase's line, and keep it in OUT/phases.log (the kernels'
    JSON line can outgrow the end of the output a caller keeps)."""
    line = f"[{name}] {msg}"
    print(line, flush=True)
    with open(os.path.join(OUT, "phases.log"), "a") as fh:
        fh.write(line + "\n")


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
    closest, 1 any hit, 2 sun; W 1 for the 8-ary walk), the dense-block
    conv's as "rdb_conv_kernel<CG,WR,WC>" (CG groups of 8 output
    channels, a block of WR x WC warps), the others by name."""
    import re
    regs, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            inst = re.search(r"path_render_kernelILj(\d+)E", mangled)
            walk = re.search(r"traverse_kernelILi(\d)ELb(\d)E", mangled)
            dense = re.search(r"rdb_conv_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                              mangled)
            name = (f"path_render_kernel<{inst.group(1)}>" if inst else
                    f"traverse_kernel<{walk.group(1)},{walk.group(2)}>"
                    if walk else
                    "rdb_conv_kernel<{},{},{}>".format(*dense.groups())
                    if dense else
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


def lit_compare(img_k, img_c) -> dict:
    """Two frames over the pixels lit in either: the frame's share of
    them, each frame's lit count, the share of them identical, and their
    mean |d| and mean signed difference (k - c) in u8."""
    lit = (img_k.max(-1) > 0) | (img_c.max(-1) > 0)
    d = img_k[lit].astype(int) - img_c[lit].astype(int)
    return dict(lit_share=float(lit.mean()),
                lit=[int((img_k.max(-1) > 0).sum()),
                     int((img_c.max(-1) > 0).sum())],
                identical=float((np.abs(d).max(-1) == 0).mean()),
                mean_abs_u8=float(np.abs(d).mean()),
                mean_signed_u8=float(d.mean()))


def count_syncs(fn) -> int:
    """Host-device synchronisations in one call of `fn`, as PyTorch's
    sync debug mode reports them (.item(), bool() of a CUDA tensor,
    nonzero, blocking copies)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        # the first switch to the mode in a process warns that it is a
        # prototype ("... synchronizing operations"): not a sync of `fn`
        del caught[:]
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def issue_syncs(args, scene, frames, dev) -> int:
    """Host-device synchronisations of the driver's issue path over two
    frames: for each, `frame_inputs` then `render_frame_async` in the
    mode --mode resolves to, the second issued while the first is in
    flight, as the pipelined frame loop does.  One frame is issued and
    finished first (the kernel library, the scene's records), and the
    two after the count."""
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.render import (FUSED_DISPATCH_RAYS, finish,
                                       render_frame_async)
    cfg = driver.render_config(args)
    budget = (FUSED_DISPATCH_RAYS if args.dispatch_rays is None
              else args.dispatch_rays)

    def issue(frame):
        s, cam = driver.frame_inputs(args, scene, frame, dev)
        return render_frame_async(s, cam, cfg,
                                  mode=driver.resolve_mode(args.mode, s, cfg),
                                  spp_batch=args.spp_batch, budget=budget)

    finish(issue(frames[0]))
    issued = []
    n = count_syncs(lambda: issued.extend(issue(f) for f in frames[:2]))
    for frame in issued:
        finish(frame)
    return n


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
    with mock.patch.object(esrgan, "fp32_scope", tf32_convs):
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


def dense_block_phase(dev, frame: np.ndarray, card: str) -> dict:
    """Phase 19 dense: the dense blocks' conv kernel (ops/rdb_conv.py).
    (a) Two RRDBs at 64/32 and at 8/4 on DENSE_CHECK images: each dense
    block's output through the kernel against the plain version on the
    card (max |d| over max |out|, <= 1e-5).  (b) The frame of phase 5
    through upscale_u8 (RRDBNet-23 x4, 64/32, seeded as phase 19) with
    the kernel against the plain trunk: u8 identical >= 99.99%, and the
    kernel's launches a forward.  (c) Widths the kernel does not take
    raise on the card.  (d) At the cell's shape (DENSE_TILES x 128 x 128,
    64/32): each conv's and a whole dense block's time (CUDA-event mean)
    against its bound (operations at 67 TFLOP/s), the plain version
    (rdb_conv_plain on the card) and the block module's own forward
    (cuDNN convs and torch.cat: `library_ms`, which the port never
    calls); the trunk's device time in a profiled forward of the frame,
    kernel against the rest."""
    import functools
    from unittest import mock
    from torch.profiler import ProfilerActivity, profile
    from dsrt_tpu_torch.models import esrgan
    from dsrt_tpu_torch.ops import build, rdb_conv

    def recorder(conv, outs):
        def run(src, cin, m, dst, off, mode):
            conv(src, cin, m, dst, off, mode)
            if mode != rdb_conv.LRELU:
                outs.append(dst[..., :m.out_channels].clone())
        return run

    # (a) each block's output, kernel against plain, on the card
    checks = {}
    n, h, w = DENSE_CHECK
    for nf, gc in ((64, 32), (8, 4)):
        torch.manual_seed(ESRGAN_SEED)
        body = torch.nn.Sequential(*[esrgan.RRDB(nf, gc) for _ in range(2)])
        with torch.no_grad():
            for m in body.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.bias.normal_(0.0, 0.05)
        body = body.to(dev)
        feat = torch.randn(n, nf, h, w, device=dev)
        got, want = [], []
        with torch.inference_mode(), esrgan.fp32_scope():
            esrgan.dense_trunk(body, feat, recorder(rdb_conv.rdb_conv, got))
            esrgan.dense_trunk(body, feat,
                               recorder(rdb_conv.rdb_conv_plain, want))
        torch.cuda.synchronize()
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want)]
        checks[f"{nf}/{gc}"] = rel
        phase("19 dense", f"{card}; (a) {nf}/{gc}, {n} images of {h}x{w}: "
                          f"each block's output, kernel against plain on "
                          f"the card, max |d| / max |out| "
                          f"{', '.join(f'{r:.3g}' for r in rel)} "
                          f"(tolerance <= 1e-5)")
        require(len(rel) == 6 and max(rel) <= 1e-5,
                f"dense block kernel at {nf}/{gc} disagrees with plain")
    # (b) the frame through the kernel and through the plain trunk
    params = lively_params(np.random.default_rng(ESRGAN_SEED), 4)
    net = esrgan.rrdbnet_from_params(params, 4, device=dev)
    plain_trunk = functools.partial(esrgan.dense_trunk,
                                    conv=rdb_conv.rdb_conv_plain)
    rdb_conv.reset_launches()
    up = esrgan.upscale_u8(net, frame)
    launches = rdb_conv.LAUNCHES["dsrt_rdb_conv"]
    with mock.patch.object(esrgan, "dense_trunk", plain_trunk):
        up_plain = esrgan.upscale_u8(net, frame)
    same, dmax = u8_agreement(up, up_plain)
    want_launches = 15 * len(net.body)
    phase("19 dense", f"{card}; (b) x4 frame {frame.shape[1]}x"
                      f"{frame.shape[0]}, kernel against the plain trunk: "
                      f"u8 identical {same:.5%}, max |d| {dmax}; "
                      f"{launches} launches a forward ({want_launches} "
                      f"wanted) (tolerance >= 99.99%)")
    require(same >= 0.9999 and launches == want_launches,
            "the frame through the dense kernel")
    # (c) widths the kernel does not take
    wide = esrgan.RRDB(128, 32).to(dev)
    raised = ""
    try:
        with torch.inference_mode():
            esrgan.dense_trunk(torch.nn.Sequential(wide),
                               torch.zeros(1, 128, 8, 8, device=dev))
    except ValueError as e:
        raised = str(e)
    phase("19 dense", f"(c) 128/32 on the card raises: {raised[:120]!r}")
    require("dsrt_rdb_conv" in raised, "a width the kernel does not take")
    # (d) times at the cell's shape
    nf, gc, hw = 64, 32, ESRGAN_TILE
    rdb = net.body[0].rdb1
    width = nf + 4 * gc
    buf = torch.randn(DENSE_TILES, hw, hw, width, device=dev)
    out = torch.empty_like(buf)
    pix = DENSE_TILES * hw * hw
    convs = [(nf + i * gc, getattr(rdb, f"conv{i + 1}"), buf, nf + i * gc,
              rdb_conv.LRELU) for i in range(4)]
    convs.append((width, rdb.conv5, out, 0, rdb_conv.RESIDUAL))

    def block(conv):
        for cin, m, dst, off, mode in convs:
            conv(buf, cin, m, dst, off, mode)

    x = buf[..., :nf].permute(0, 3, 1, 2).contiguous()
    per_conv = []
    with torch.inference_mode(), esrgan.fp32_scope():
        for cin, m, dst, off, mode in convs:
            ms = event_ms(lambda: rdb_conv.rdb_conv(buf, cin, m, dst, off,
                                                    mode), 20)
            flops = 2 * 9 * pix * cin * m.out_channels
            per_conv.append(dict(cin=cin, cout=m.out_channels, ms=ms,
                                 bound_ms=flops / H100_FP32_FLOPS * 1e3,
                                 peak_share=flops / H100_FP32_FLOPS * 1e3
                                 / ms))
        kernel_ms = event_ms(lambda: block(rdb_conv.rdb_conv), 20)
        plain_ms = event_ms(lambda: block(rdb_conv.rdb_conv_plain), 5)
        library_ms = event_ms(lambda: rdb(x), 10)
    flops = sum(2 * 9 * pix * c["cin"] * c["cout"] for c in per_conv)
    bound_ms = flops / H100_FP32_FLOPS * 1e3
    phase("19 dense", f"{card}; (d) a dense block at {DENSE_TILES}x{hw}x"
                      f"{hw}, 64/32: kernel {kernel_ms:.3f} ms, bound "
                      f"{bound_ms:.3f} ms ({flops / 1e12:.3f} TFLOP at 67 "
                      f"TFLOP/s; {bound_ms / kernel_ms:.1%} of FP32 peak); "
                      f"plain {plain_ms:.3f} ms; library (cuDNN + "
                      f"torch.cat) {library_ms:.3f} ms; per conv "
                      + ", ".join(f"{c['cin']}->{c['cout']} {c['ms']:.3f} "
                                  f"ms ({c['peak_share']:.1%})"
                                  for c in per_conv))
    # the frame's forward: the trunk's kernel time against the rest
    tiles, _ = esrgan.tile_grid(frame.astype(np.float32) / 255.0,
                                ESRGAN_TILE, ESRGAN_OVERLAP)
    esrgan.forward_tiles(net, tiles, u8=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        esrgan.forward_tiles(net, tiles, u8=True)
        torch.cuda.synchronize()
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0) / 1e3,
                   e.count) for e in prof.key_averages()),
                 key=lambda t: -t[1])
    ops = [o for o in ops if o[1] > 0]
    dense_ms = sum(t for k, t, _ in ops if "rdb_conv_kernel" in k)
    total_ms = sum(t for _, t, _ in ops)
    trunk_flops = flops * len(net.body) * 3 // DENSE_TILES * len(tiles)
    trunk_share = (trunk_flops / H100_FP32_FLOPS / dense_ms * 1e3
                   if dense_ms else float("nan"))
    phase("19 dense", f"{card}; (d) the frame's forward ({len(tiles)} "
                      f"tiles): device {total_ms:.1f} ms, of it the dense "
                      f"kernel {dense_ms:.1f} ms ({trunk_flops / 1e12:.2f} "
                      f"TFLOP, {trunk_share:.1%} of FP32 peak); top ops "
                      + "; ".join(f"{k[:60]} {t:.1f} ms x{c}"
                                  for k, t, c in ops[:8]))
    regs = {k: v for k, v in register_counts(build.build_info["log"]).items()
            if "rdb_conv" in k}
    log = build.build_info["log"]
    spills = [ln.strip() for ln in
              log[log.find("== rdb_conv.cu"):].splitlines()[1:]
              if "spill" in ln]
    return dict(card=card, block_rel_err=checks, frame_u8_identical=same,
                frame_u8_max_d=dmax, launches_a_forward=launches,
                raises=raised, per_conv=per_conv, ms=kernel_ms,
                bound_ms=bound_ms, plain_ms=plain_ms, library_ms=library_ms,
                forward_device_ms=total_ms, forward_dense_ms=dense_ms,
                forward_top_ops=ops[:12], registers=regs,
                spill_lines=spills[:3])


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


def run_groups(cmds, logs, env, timeout: float) -> list:
    """Run each command in a process group of its own, all at once, its
    output to its log; wait for all and return their exit codes.  Every
    group still running at `timeout` seconds is killed and the wait
    raises."""
    procs, files = [], []
    try:
        for cmd, log in zip(cmds, logs):
            files.append(open(log, "w"))
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=files[-1],
                stderr=subprocess.STDOUT, start_new_session=True))
        deadline = time.monotonic() + timeout
        return [p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in files:
            f.close()


def pngs_of(folder: str) -> dict:
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


def sharded_rank(jobs, out: str, times: str, device: str, reps: int) -> None:
    """Phase 21's rank function: parallel.dryrun.render_jobs over `jobs`
    (the counted frames), then for each fused job the rank's list launch,
    ranks in turn (CUDA events, mean of `reps`, and its exact rays), and
    on rank 0 the sharded call (host clock from a barrier to the image,
    least of `reps`) and the gather alone.  Rank 0 saves {job name: [each
    rank's times]} to `times`."""
    import torch.distributed as dist

    from dsrt_tpu_torch.parallel.dryrun import job_inputs, render_jobs
    from dsrt_tpu_torch.parallel.render import (gather_frame, rank_shard,
                                                render_frame_fused_sharded,
                                                shard_pixels)
    from dsrt_tpu_torch.render import fused_accum, tonemap_u8
    render_jobs(jobs, out, device)
    found, scenes = {}, {}
    for job in (j for j in jobs if j.fused):
        mesh, scene, cam = job_inputs(job, device, scenes)
        cfg, spp = job.cfg, job.cfg.resolved_spp()
        shard = rank_shard(cfg, mesh)
        pix = shard_pixels(shard, mesh.device)

        def launch():
            return fused_accum(scene, cam, cfg, spp, 0, pix)

        mine = {}
        for r in range(dist.get_world_size()):
            if r == mesh.rank:
                mine.update(kernel_ms=event_ms(launch, reps),
                            rays=int(launch()[1]))
            dist.barrier()
        walls = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            render_frame_fused_sharded(scene, cam, cfg, mesh)
            walls.append(time.perf_counter() - t0)
        rows = tonemap_u8(launch()[0], cfg, spp)
        torch.cuda.synchronize()
        gathers = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            gather_frame(mesh, cfg, shard, rows)
            gathers.append(time.perf_counter() - t0)
        mine.update(wall_s=min(walls), gather_s=min(gathers))
        every = [None] * dist.get_world_size() if mesh.rank == 0 else None
        dist.gather_object(mine, every, dst=0)
        found[job.name] = every
    if dist.get_rank() == 0:
        torch.save(found, times)


@contextlib.contextmanager
def traversal_waves():
    """Inside the block every plain walk on the card
    (ops/trace.lane_traverse, the walk of `walk="plain"` frames) also
    launches the traversal kernel on the same rays.  Yields, per query
    ("closest", "any"), the calls, lanes, active lanes, mismatches
    ((t, u, v, tri) of the closest hit, hit masks of the any-hit query;
    tolerance none), max |d| of t, the summed CUDA-event times of the
    plain walk and of the kernel's wrapper call, the plain walk's visits
    and tests, and the summed bound of the calls (traverse.bound_ms from
    those visits and tests), split by the resource that bounds each."""
    from dsrt_tpu_torch.ops import trace
    from dsrt_tpu_torch.ops import traverse as tv
    orig = trace.lane_traverse
    stats = {q: dict(calls=0, lanes=0, active=0, mismatches=0,
                     max_abs_err=0.0, plain_ms=0.0, ms=0.0, visits=0,
                     tests=0, bound_ms={"bytes": 0.0, "operations": 0.0})
             for q in ("closest", "any")}

    def walk(scene, ro, rd, t_min, t_max, active, any_hit=False):
        st = stats["any" if any_hit else "closest"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        with trace.walk_counter() as wc:
            ev[0].record()
            want = orig(scene, ro, rd, t_min, t_max, active, any_hit=any_hit)
            ev[1].record()
        got = tv.traverse(scene, ro, rd, active, t_min, t_max,
                          any_hit=any_hit)
        ev[2].record()
        torch.cuda.synchronize()
        if any_hit:
            mism = int(((got[3] >= 0) != (want[3] >= 0)).sum())
        else:
            mism = int(((got[0] != want[0]) | (got[1] != want[1])
                        | (got[2] != want[2]) | (got[3] != want[3])).sum())
            st["max_abs_err"] = max(st["max_abs_err"], float(
                (got[0] - want[0]).abs().max()))
        n_act = int(active.sum())
        visits, tests = int(wc["visits"]), int(wc["tests"])
        bound, by = tv.bound_ms(scene, active.numel(),
                                tv.ray_bytes(ro, rd, n_act), visits, tests)
        st["bound_ms"][by] += bound
        for k, v in (("calls", 1), ("lanes", active.numel()),
                     ("active", n_act), ("mismatches", mism),
                     ("plain_ms", ev[0].elapsed_time(ev[1])),
                     ("ms", ev[1].elapsed_time(ev[2])), ("visits", visits),
                     ("tests", tests)):
            st[k] += v
        return want

    trace.lane_traverse = walk
    try:
        yield stats
    finally:
        trace.lane_traverse = orig


def traverse_frame_ms(fn, tries: int = 4) -> dict:
    """{query: (kernel device ms in all, launches recorded)} of the
    traversal kernels in one call of `fn`, from a device-only
    torch.profiler session, taken again (up to `tries` sessions) when it
    recorded no traversal kernel; raises after that."""
    from torch.profiler import ProfilerActivity, profile

    from dsrt_tpu_torch.ops import traverse as tv
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {q: (0.0, 0) for q in tv.QUERIES}
        for e in prof.key_averages():
            # traverse_kernel<kind, wide>, kind = tv.QUERIES' index
            m = re.search(r"traverse_kernel(?:<|ILi)(\d)", e.key)
            if m and getattr(e, "self_device_time_total", 0):
                ms, n = out[tv.QUERIES[int(m.group(1))]]
                out[tv.QUERIES[int(m.group(1))]] = (
                    ms + e.self_device_time_total / 1e3, n + e.count)
        if any(n for _, n in out.values()):
            return out
    raise RuntimeError(f"torch.profiler recorded no traversal kernel in "
                       f"{tries} sessions")


def sharded_phase(dev, card: str, flagship, shard_work, poses: str,
                  frames: str) -> dict:
    """Phase 21: the sharded renders (dsrt_tpu_torch/parallel/).  (a) A
    1-rank NCCL mesh in this process renders the flagship through
    render_frame_fused_sharded.  (b) SHARD_DP ranks (spawned, sharing
    cuda:0, so gloo; `sharded_rank`) render the flagship and rtiow
    dp-sharded, each rank one list launch of its shard; each rank's list
    launch is timed in turn (CUDA events) and bounded (the flagship from
    phase 5's per-shard work, rtiow from the rank's exact rays), and rank
    0 times the sharded call and the gather alone.  (c) The same ranks
    render the flagship at sp = SHARD_DP through the traversal kernels;
    this process renders the slice emulation through the plain walk on
    the card, which launches the traversal kernel beside each plain walk
    (`traversal_waves`): its queries are the ranks' queries, timed and
    bounded at the frame's own waves.  (d) The driver under
    torch.distributed.run with --shard, and with --hosts as independent
    processes, over phase 6's poses and flags.  Each must equal its
    single-process counterpart."""
    from dsrt_tpu_torch.config import RenderConfig
    from dsrt_tpu_torch.models import presets
    from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                                write_panel_texture)
    from dsrt_tpu_torch.ops import path_kernel
    from dsrt_tpu_torch.ops.camera import make_camera, point_camera_at
    from dsrt_tpu_torch.ops.traverse import (MT_FLOPS, SLAB_FLOPS,
                                             roofline_ms)
    from dsrt_tpu_torch.parallel.dryrun import Job
    from dsrt_tpu_torch.parallel.mesh import leave, make_mesh, spawn_ranks
    from dsrt_tpu_torch.parallel.render import (render_frame_fused_sharded,
                                                render_frame_sp_emulated)
    from dsrt_tpu_torch.render import render_frame_fused

    tex = os.path.join(OUT, "panel.png")
    write_panel_texture(tex)
    cfg = RenderConfig(width=800, height=450, spp=32, max_depth=50)
    cam = point_camera_at(BENCH_CAM, vfov=cfg.vfov, width=800, height=450,
                          device=dev)
    single_s, _, (img, rays) = wall_time(
        lambda: render_frame_fused(flagship, cam, cfg, with_count=True), 3)

    # (a) one rank, its own card: NCCL
    path_kernel.reset_launches()
    mesh = make_mesh(sp=1, device=dev)
    try:
        img_a, rays_a = render_frame_fused_sharded(flagship, cam, cfg, mesh,
                                                   with_count=True)
        backend = mesh.backend
    finally:
        leave()
    launches_a = path_kernel.LAUNCHES["dsrt_path_render"]
    same_a = np.array_equal(img_a, img)
    phase("21 sharded", f"{card}; (a) 1-rank mesh, backend {backend}: "
                        f"flagship 800x450 spp32 u8 identical to "
                        f"render_frame_fused {same_a}, rays {rays_a} vs "
                        f"{rays} (tolerance: identical), path kernel "
                        f"launches {launches_a}")
    require(backend == "nccl" and same_a and rays_a == rays
            and launches_a == 1, "1-rank sharded flagship")

    # (b), (c) SHARD_DP ranks on this card
    rt_cfg = RenderConfig(width=400, height=225, spp=64, max_depth=50)
    rt_look = dict(lookfrom=(0.0, 0.6, 2.0), lookat=(0.0, 0.0, -1.0),
                   vfov=50, width=400, height=225)
    flag_scene = functools.partial(iss_standin_scene, detail=12,
                                   tex_path=tex)
    flag_cam = functools.partial(point_camera_at, BENCH_CAM, vfov=cfg.vfov,
                                 width=800, height=450)
    jobs = [Job("flagship", flag_scene, flag_cam, cfg, fused=True),
            Job("rtiow", presets.rtiow_smoke_scene,
                functools.partial(make_camera, **rt_look), rt_cfg,
                fused=True),
            Job("flagship sp", flag_scene, flag_cam, cfg, sp=SHARD_DP)]
    out = os.path.join(OUT, "sharded_jobs.pt")
    times = os.path.join(OUT, "sharded_times.pt")
    t0 = time.perf_counter()
    spawn_ranks(sharded_rank, SHARD_DP, jobs, out, times, dev.type,
                SHARD_REPS, timeout=SHARD_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    res = torch.load(out, weights_only=False)
    timed = torch.load(times, weights_only=False)
    rt_scene = presets.rtiow_smoke_scene(device=dev)
    rt_cam = make_camera(**rt_look, device=dev)
    rt_single_s, _, (rt_img, rt_rays) = wall_time(
        lambda: render_frame_fused(rt_scene, rt_cam, rt_cfg,
                                   with_count=True), 3)
    summary = {"ranks_process_s": ranks_s,
               "flagship 1 rank": dict(launches=launches_a, backend=backend)}
    for name, kname, ref_img, ref_rays, single in (
            ("flagship", "dsrt_path_render", img, rays, single_s),
            ("rtiow", "dsrt_sphere_render", rt_img, rt_rays, rt_single_s)):
        r = res[name]
        same = np.array_equal(r["img"], ref_img)
        per = []
        for rk, tk in zip(r["ranks"], timed[name]):
            if name == "flagship":
                work = shard_work[rk["dp_index"]]
                bound = roofline_ms(
                    work["visits"] * SLAB_FLOPS + work["tests"] * MT_FLOPS,
                    table_bytes(flagship, PATH_TABLES) + rk["pixels"] * 12)
            else:
                bound = roofline_ms(
                    tk["rays"] * (SPHERE_FLOPS * rt_scene.n_spheres
                                  + MEDIUM_FLOPS * rt_scene.n_media),
                    table_bytes(rt_scene, ("mat_pack", "tex_pool"))
                    + 247 * 4 + rk["pixels"] * 12)
            per.append(dict(rk, **tk, bound_ms=bound[0], bound_by=bound[1]))
        wall, gather = per[0]["wall_s"], per[0]["gather_s"]
        phase("21 sharded",
              f"{card}; (b) {name} {ref_img.shape[1]}x{ref_img.shape[0]} "
              f"spp{(cfg if name == 'flagship' else rt_cfg).spp} at "
              f"dp={SHARD_DP}, {SHARD_DP} ranks sharing {dev}: u8 "
              f"identical to render_frame_fused {same}, rays {r['rays']} vs "
              f"{ref_rays} (tolerance: identical); "
              + "; ".join(f"rank {p['rank']}: {p['pixels']} pixels, "
                          f"{p['launches'][kname]} {kname} launch, list "
                          f"launch {p['kernel_ms']:.3f} ms (CUDA events, "
                          f"mean of {SHARD_REPS}, ranks in turn), bound "
                          f"{p['bound_ms']:.4f} ms by {p['bound_by']}, "
                          f"{p['rays']} rays" for p in per)
              + f"; sharded call {wall * 1e3:.3f} ms on rank 0 (least of "
                f"{SHARD_REPS}) against render_frame_fused "
                f"{single * 1e3:.3f} ms (least of 3); the gather alone "
                f"{gather * 1e3:.3f} ms, {gather / wall:.1%} of the call")
        require(same and r["rays"] == ref_rays
                and all(p["launches"][kname] == 1 for p in per),
                f"sharded {name} frame")
        summary[name] = dict(ranks=per, wall_ms=wall * 1e3,
                             single_ms=single * 1e3, gather_ms=gather * 1e3,
                             launches=sum(p["launches"][kname] for p in per))

    t0 = time.perf_counter()
    with traversal_waves() as waves:
        want = render_frame_sp_emulated(flagship, cam, cfg, sp=SHARD_DP,
                                        walk="plain")
    emu_s = time.perf_counter() - t0
    # the kernels' device time at the same waves: the emulation through
    # the traversal kernels, profiled
    prof = traverse_frame_ms(lambda: render_frame_sp_emulated(
        flagship, cam, cfg, sp=SHARD_DP))
    r = res["flagship sp"]
    same_c = np.array_equal(r["img"], want)
    walks = ("dsrt_traverse", "dsrt_traverse any-hit", "dsrt_traverse_sun")
    trav = {k: sum(rk["launches"][k] for rk in r["ranks"]) for k in walks}
    lit = float((r["img"] > 0).mean())
    for kname, query in (("dsrt_traverse", "closest"),
                         ("dsrt_traverse any-hit", "any")):
        w = waves[query]
        w["bound_by"] = max(w["bound_ms"], key=w["bound_ms"].get)
        w["bound_ms"] = sum(w["bound_ms"].values())
        w["wrapper_ms"] = w.pop("ms")
        w["kernel_ms"], w["kernel_launches"] = prof[query]
        n = max(w["calls"], 1)
        k_ms = w["kernel_ms"] / max(w["kernel_launches"], 1)
        phase("21 sharded",
              f"{card}; (c) {kname} at the flagship's sp={SHARD_DP} waves: "
              f"{trav[kname]} launches on the ranks, {w['calls']} plain "
              f"walks in the emulation, {w['lanes']} lanes, "
              f"{w['active']} active; {w['mismatches']} mismatches "
              f"({'hit masks' if query == 'any' else '(t,u,v,tri)'}; "
              f"tolerance: none), max |d| t {w['max_abs_err']:.3g}; kernel "
              f"{w['kernel_ms']:.3f} ms in all over {w['kernel_launches']} "
              f"recorded launches, {k_ms:.4f} ms a launch (profiler device "
              f"time); wrapper {w['wrapper_ms']:.1f} ms in all, "
              f"{w['wrapper_ms'] / n:.4f} ms a call (CUDA events around "
              f"each call on an idle stream, the wrapper's host work "
              f"included); plain walk {w['plain_ms']:.1f} ms, "
              f"{w['plain_ms'] / n:.2f} ms a call; bound {w['bound_ms']:.4f} "
              f"ms in all, {w['bound_ms'] / n:.5f} ms a launch, by "
              f"{w['bound_by']} ({w['visits']} visits, {w['tests']} tests)")
        require(w["mismatches"] == 0 and w["calls"] == trav[kname] > 0
                and w["kernel_launches"] > 0,
                f"{kname} at the sharded flagship's waves")
    phase("21 sharded", f"{card}; (c) flagship 800x450 spp32 depth50 at "
                        f"sp={SHARD_DP}, {SHARD_DP} ranks sharing {dev}: "
                        f"identical to render_frame_sp_emulated(sp="
                        f"{SHARD_DP}, walk='plain') on the card {same_c} "
                        f"(tolerance: identical; emulation {emu_s:.1f} s), "
                        f"lit {lit:.2f}, launches on the ranks {trav}")
    require(same_c and trav["dsrt_traverse"] > 0 and lit > 0.01,
            "sample-sliced flagship frame")
    summary["flagship sp"] = dict(launches=trav, emulation_s=emu_s,
                                  waves=waves)

    # (d) the driver: torch.distributed.run --shard, and --hosts as
    # independent processes, over phase 6's poses and flags
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    flags = ["--input_txt", poses, "--wipe", "--width", "320", "--height",
             "180", "--spp", "16", "--standin_detail", "12",
             "--standin_tex", tex, "--device", dev.type]
    driver = [sys.executable, "-m", "dsrt_tpu_torch.driver"]
    shard_dir = os.path.join(OUT, "frames_shard")
    t0 = time.perf_counter()
    rc_t, = run_groups(
        [[sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc_per_node", str(SHARD_DP), "-m", "dsrt_tpu_torch.driver",
          "--output_dir", shard_dir, "--shard", *flags]],
        [os.path.join(OUT, "driver_shard.log")], env, SHARD_TIMEOUT)
    torchrun_s = time.perf_counter() - t0
    host_dirs = [os.path.join(OUT, f"frames_host{i}") for i in range(2)]
    t0 = time.perf_counter()
    rc_h = run_groups(
        [driver + ["--output_dir", d, "--hosts", "2", "--host_id", str(i),
                   *flags] for i, d in enumerate(host_dirs)],
        [os.path.join(OUT, f"driver_host{i}.log") for i in range(2)], env,
        SHARD_TIMEOUT)
    hosts_s = time.perf_counter() - t0
    want_d = pngs_of(frames)
    got_t = pngs_of(shard_dir) if rc_t == 0 else {}
    got_h = [pngs_of(d) if rc == 0 else {} for d, rc in zip(host_dirs, rc_h)]
    with open(os.path.join(OUT, "driver_shard.log")) as fh:
        sharded_lines = fh.read().count("render (fused sharded over 1x2")
    phase("21 sharded", f"(d) driver, phase 6's 2 poses 320x180 spp16: "
                        f"torch.distributed.run --nproc_per_node {SHARD_DP} "
                        f"--shard rc {rc_t} in {torchrun_s:.1f} s, PNGs "
                        f"{sorted(got_t)} byte-identical to the unsharded "
                        f"driver's {got_t == want_d}, fused sharded frames "
                        f"{sharded_lines}; --hosts 2 as two processes rc "
                        f"{rc_h} in {hosts_s:.1f} s, PNGs "
                        f"{[sorted(g) for g in got_h]}, union identical "
                        f"{dict(got_h[0], **got_h[1]) == want_d}")
    require(rc_t == 0 and len(want_d) == 2 and got_t == want_d
            and sharded_lines == 2, "torch.distributed.run --shard driver")
    require(rc_h == [0, 0] and len(got_h[0]) == 1 and len(got_h[1]) == 1
            and dict(got_h[0], **got_h[1]) == want_d, "--hosts driver")
    summary["driver"] = dict(torchrun_s=torchrun_s, hosts_s=hosts_s)
    return summary


def rendezvous_args(poses: str, out_dir: str, size) -> list:
    """The driver's arguments of docs/RUN_RENDEZVOUS.md's runs: the
    textured detail-12 stand-in, --mode auto, at `size` (width, height,
    spp)."""
    w, h, spp = size
    return ["--input_txt", poses, "--output_dir", out_dir,
            "--standin_detail", "12", "--standin_tex", RDV_TEX, "--width",
            str(w), "--height", str(h), "--spp", str(spp), "--mode", "auto"]


def rendezvous_drive(tag: str, poses: str, size) -> dict:
    """The driver over a pose file with rendezvous_args, --timings_tsv and
    --wipe, its stdout to OUT/rendezvous/<tag>.log: its exit code and
    wall, the PNGs, the kernels' launches in the run (counts set to 0
    just before), how often the path kernel's wrapper made the scene's
    parameter records and a sun vector, and tools/sequence_stats of the
    run."""
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.models.scene import Scene
    from dsrt_tpu_torch.ops import path_kernel, sphere_kernel
    from dsrt_tpu_torch.ops import traverse as tv
    from dsrt_tpu_torch.tools.sequence_stats import sequence_stats
    out = os.path.join(OUT, "rendezvous")
    out_dir, log = os.path.join(out, tag), os.path.join(out, f"{tag}.log")
    tsv = os.path.join(out, f"{tag}.tsv")
    made = {"path_params": 0, "sun": 0}
    cached = Scene.cached

    def counting(scene, key, sources, make):
        def counted():
            if key.split()[0] in made:
                made[key.split()[0]] += 1
            return make()
        return cached(scene, key, sources, counted)

    path_kernel.reset_launches()
    sphere_kernel.reset_launches()
    tv.reset_launches()
    Scene.cached = counting
    try:
        with open(log, "w") as fh, contextlib.redirect_stdout(fh):
            t0 = time.perf_counter()
            rc = driver.main(rendezvous_args(poses, out_dir, size)
                             + ["--timings_tsv", tsv, "--wipe"])
            wall = time.perf_counter() - t0
    finally:
        Scene.cached = cached
    launches = dict(path_kernel.LAUNCHES, **sphere_kernel.LAUNCHES,
                    **tv.LAUNCHES)
    with open(log) as fh:
        stats = sequence_stats(fh.read(), tsv)
    return dict(rc=rc, wall_s=wall, out_dir=out_dir, launches=launches,
                made=made, pngs=sorted(f for f in os.listdir(out_dir)
                                       if f.endswith(".png")), **stats)


def held_at_pixels(scene, cam, cfg, spp: int, salt: int, acc) -> dict:
    """One frame launch of the path kernel at its own shape (`acc`, its
    (H, W, 3) accumulator of `spp` samples under the salt `salt`) against
    the plain version at a pixel list: up to RDV_PIXELS[0] of the launch's
    lit pixels and RDV_PIXELS[1] drawn uniformly.  The launch's rows
    there, the kernel's list launch at the same pixels and the plain
    version's rows must be equal, and the list launch's ray count the
    plain version's.  The plain version runs on CPU copies of the scene
    and camera (bit-identical to the card's, as phase 13 holds it): its
    samples run one after another, each waiting on its walk's steps, and
    on the host a step waits on no device."""
    from dsrt_tpu_torch.ops import path_kernel
    flat = acc.reshape(-1, 3)
    lit = torch.nonzero(flat.amax(-1) > 0).flatten().cpu().numpy()
    rng = np.random.default_rng(RDV_PIXEL_SEED)
    n_lit, n_uniform = RDV_PIXELS
    picked = (lit if len(lit) <= n_lit
              else rng.choice(lit, n_lit, replace=False))
    drawn = rng.choice(flat.shape[0], n_uniform, replace=False)
    pix = torch.as_tensor(np.unique(np.concatenate([picked, drawn])))
    rows_l, n_l = path_kernel.path_render(scene, cam, cfg, spp, salt=salt,
                                          pixels=pix.to(acc.device))
    t0 = time.perf_counter()
    rows_p, n_p = path_kernel.path_render_plain(
        scene.to("cpu"), cam.to("cpu"), cfg, spp, salt=salt, pixels=pix)
    plain_s = time.perf_counter() - t0
    same = (torch.equal(flat[pix.to(acc.device)].cpu(), rows_p)
            and torch.equal(rows_l.cpu(), rows_p) and int(n_l) == int(n_p))
    return dict(identical=same, spp=spp, salt=salt, pixels=int(pix.numel()),
                lit_in_launch=int(len(lit)), lit_listed=int(len(picked)),
                rays=int(n_p), plain_cpu_s=plain_s)


def rendezvous_phase(dev, card: str) -> dict:
    """Phase 22: docs/RUN_RENDEZVOUS.md's sequence through the port's
    entry points on the card.  The orbit CLI writes its 99 poses (--time
    1 --dt 0.01); the driver renders all of them as Run A (800x450, 250
    spp, one path kernel launch a frame) and poses 0, 49 and 98 as Run B
    (1920x1080, 1000 spp: 8 salted chunk launches a frame); each Run B
    frame is rendered again through render_accum_fused on the driver's
    scene, camera and sun, with each chunk launch timed, and must be
    u8-identical to the driver's PNG with the same ray count.  One chunk
    launch of each Run B frame (RDV_CHUNKS) and Run A's launch at pose
    RDV_A_POSE are held against the plain version on the card at their
    own shapes, spp and salts (held_at_pixels).  The frames are compared
    with the JAX package's frames of the same runs over their lit pixels
    (lit_compare).  At poses 49 and 98 (160x90, 4 spp, depth 50)
    render_frame_fused must equal the path kernel's plain version on the
    card in every pixel and ray count; the plain version's node visits and
    triangle tests, scaled to Run A's and Run B's frames, give the
    kernel's bound at those poses.  Last, `issue_syncs` at Run A's and
    Run B's settings on a RDV_SYNC_FRAME frame (Run B's in 8 chunk
    launches a frame) must count no synchronisation."""
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.ops import path_kernel
    from dsrt_tpu_torch.ops.trace import walk_counter
    from dsrt_tpu_torch.ops.traverse import (MT_FLOPS, SLAB_FLOPS,
                                             roofline_ms)
    from dsrt_tpu_torch.orbit import cli as orbit_cli
    from dsrt_tpu_torch.render import (fused_chunk_spp, render_accum_fused,
                                       render_frame_fused, tonemap)
    from dsrt_tpu_torch.utils.image_io import read_png
    from dsrt_tpu_torch.utils.pose import read_pose_file
    from dsrt_tpu_torch.utils.timing import StageTimer
    from dsrt_tpu_torch.utils.transform import pose_to_frame
    out = os.path.join(OUT, "rendezvous")
    os.makedirs(out, exist_ok=True)

    # 1. the poses, from the orbit CLI on the card
    poses99 = os.path.join(out, "poses99.txt")
    t0 = time.perf_counter()
    rc = orbit_cli.main(["--time", RDV_SPAN[0], "--dt", RDV_SPAN[1],
                         "--txt", poses99])
    cli_s = time.perf_counter() - t0
    frames = [pose_to_frame(p) for p in read_pose_file(poses99)]
    n = len(frames)
    require(rc == 0 and n == RDV_POSES and None not in frames,
            f"orbit CLI: rc {rc}, {n} poses (want {RDV_POSES})")
    sep = [f.separation_m for f in frames]
    phase("22 rendezvous",
          f"{card}; orbit CLI --time {RDV_SPAN[0]} --dt {RDV_SPAN[1]} on "
          f"the card: {n} poses in {cli_s:.2f} s; camera-model separation "
          + ", ".join(f"pose {i} {sep[i]:.1f} m" for i in RDV_SAMPLES))

    def summary(run):
        r = run["render_s"]
        return (f"rc {run['rc']}, {len(run['pngs'])} PNGs, labels "
                f"{sorted({f['label'] for f in run['frames']})}; driver "
                f"call {run['wall_s']:.1f} s (scene compile "
                f"{run['scene_compile_s']:.1f} s, frame loop "
                f"{run['loop_wall_s']} s); render stage median "
                f"{r['median']:.4f}, p10 {r['p10']:.4f}, p90 "
                f"{r['p90']:.4f}, min {r['min']:.4f}, max {r['max']:.4f} s "
                f"(sum {r['sum']:.2f}); encode {run['encode_s']:.2f} s in "
                f"all; {run['rays']} exact rays, "
                f"{run['sustained_mrays_per_s']:.1f} Mrays/s over the frame "
                f"loop; slowest frame {run['slowest']['index']} at "
                f"{run['slowest']['separation_m']:.1f} m, "
                f"{run['slowest']['render_s']:.4f} s; launches "
                f"{run['launches']}; parameter records made "
                f"{run['made']['path_params']} times, sun vector "
                f"{run['made']['sun']} times")

    def require_run(run, tag, frames_n, launches_n):
        labels = {f["label"] for f in run["frames"]}
        require(run["rc"] == 0 and len(run["pngs"]) == frames_n
                and len(run["frames"]) == frames_n
                and labels == {f"fused on {dev.type}"},
                f"{tag}: rc {run['rc']}, {len(run['pngs'])} PNGs, labels "
                f"{labels}")
        require(run["launches"]["dsrt_path_render"] == launches_n
                and run["launches"]["dsrt_sphere_render"] == 0
                and run["launches"]["dsrt_traverse"] == 0
                and run["launches"]["dsrt_traverse_sun"] == 0,
                f"{tag}: launches {run['launches']}, want "
                f"{launches_n} of the path kernel and no other")

    # 2. Run A: every pose
    w, h, spp = RDV_RUN_A
    run_a = rendezvous_drive("rdv250", poses99, RDV_RUN_A)
    phase("22 rendezvous", f"Run A {w}x{h} spp{spp} depth50, {n} poses: "
                           + summary(run_a))
    phase("22 rendezvous frames",
          "Run A (index, separation m, render s, Mrays/s, exact rays): "
          + "; ".join(f"{f['index']} {f['separation_m']:.1f} "
                      f"{f['render_s']:.4f} {f['mrays_per_s']:.1f} "
                      f"{f['rays']}" for f in run_a["frames"]))
    require_run(run_a, "Run A", n, n)

    # 3. Run B: the sample poses at 1920x1080, 1000 spp
    poses3 = os.path.join(out, "poses3.txt")
    with open(poses99) as fh:
        lines = [ln for ln in fh if ln.strip() and not ln.startswith("#")]
    with open(poses3, "w") as fh:
        fh.writelines(lines[i] for i in RDV_SAMPLES)
    w, h, spp = RDV_RUN_B
    run_b = rendezvous_drive("rdv1080", poses3, RDV_RUN_B)
    args = driver.build_parser().parse_args(
        rendezvous_args(poses3, run_b["out_dir"], RDV_RUN_B))
    cfg = driver.render_config(args)
    chunk = fused_chunk_spp(cfg)
    n_chunks = -(-spp // chunk)
    phase("22 rendezvous", f"Run B {w}x{h} spp{spp} depth50, poses "
                           f"{list(RDV_SAMPLES)}, chunks of {chunk} spp: "
                           + summary(run_b))
    require_run(run_b, "Run B", len(RDV_SAMPLES),
                len(RDV_SAMPLES) * n_chunks)
    with contextlib.redirect_stdout(sys.stderr):
        scene = driver.build_scene(args, StageTimer(), dev)
    launch = path_kernel.path_render
    replays, held = [], {}
    for k, (i, logged) in enumerate(zip(RDV_SAMPLES, run_b["frames"])):
        s, cam = driver.frame_inputs(args, scene, frames[i], dev)
        events, kept = [], {}

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = launch(*a, **kw)
            ev[1].record()
            if len(events) == RDV_CHUNKS[k]:
                kept.update(spp=a[3], salt=kw["salt"], acc=res[0])
            events.append(ev)
            return res

        path_kernel.path_render = timed
        try:
            t0 = time.perf_counter()
            acc, rays = render_accum_fused(s, cam, cfg)
            img = tonemap(acc, cfg, spp)
            secs = time.perf_counter() - t0
        finally:
            path_kernel.path_render = launch
        chunk_ms = [a.elapsed_time(b) for a, b in events]
        png = read_png(os.path.join(run_b["out_dir"], f"frame_{k:04d}.png"))
        same = bool(np.array_equal(img, png)) and int(rays) == logged["rays"]
        lit = float((png.max(-1) > 0).mean())
        replays.append(dict(pose=i, separation_m=sep[i], identical=same,
                            lit=lit, rays=int(rays), seconds=secs,
                            chunk_ms=chunk_ms,
                            mrays_per_s=int(rays) / secs / 1e6,
                            driver_render_s=logged["render_s"]))
        phase("22 rendezvous",
              f"Run B pose {i} ({sep[i]:.1f} m): driver render stage "
              f"{logged['render_s']:.3f} s, {logged['rays']} exact rays, "
              f"{logged['mrays_per_s']:.1f} Mrays/s; render_accum_fused "
              f"on the driver's scene, camera and sun: {secs:.3f} s, "
              f"{int(rays) / secs / 1e6:.1f} Mrays/s, {len(chunk_ms)} "
              f"launches of ms "
              f"{', '.join(f'{t:.1f}' for t in chunk_ms)}; u8 and rays "
              f"identical to the driver's {same} (tolerance: identical); "
              f"{lit:.4%} of pixels lit")
        require(same and len(chunk_ms) == n_chunks,
                f"Run B pose {i}: the driver's frame differs from "
                f"render_accum_fused, or {len(chunk_ms)} launches")
        held[f"run B pose {i} chunk {RDV_CHUNKS[k]}"] = held_at_pixels(
            s, cam, cfg, kept["spp"], kept["salt"], kept["acc"])
        del kept["acc"], acc

    # Run A's launch at one pose, which made the driver's frame
    args_a = driver.build_parser().parse_args(
        rendezvous_args(poses99, run_a["out_dir"], RDV_RUN_A))
    cfg_a = driver.render_config(args_a)
    s, cam = driver.frame_inputs(args_a, scene, frames[RDV_A_POSE], dev)
    acc, _ = path_kernel.path_render(s, cam, cfg_a)
    png = read_png(os.path.join(run_a["out_dir"],
                                f"frame_{RDV_A_POSE:04d}.png"))
    require(np.array_equal(tonemap(acc, cfg_a, cfg_a.spp), png),
            f"Run A pose {RDV_A_POSE}: the launch differs from the "
            "driver's frame")
    held[f"run A pose {RDV_A_POSE}"] = held_at_pixels(s, cam, cfg_a,
                                                      cfg_a.spp, 0, acc)
    del acc
    for key, v in held.items():
        phase("22 rendezvous held",
              f"{key}: the frame launch ({v['spp']} spp, salt "
              f"{v['salt']:#x}) against the plain version at "
              f"{v['pixels']} pixels ({v['lit_listed']} of its "
              f"{v['lit_in_launch']} lit pixels, the rest drawn "
              f"uniformly): rows, the list launch's rows and its ray count "
              f"identical {v['identical']} (tolerance: identical), "
              f"{v['rays']} rays; plain on the host {v['plain_cpu_s']:.1f} s")
        require(v["identical"], f"{key}: the path kernel and its plain "
                                "version differ")

    # the frames against the JAX package's frames of the same runs
    reference = {}
    for (run, i), name in RDV_REFERENCE.items():
        png = (os.path.join(run_a["out_dir"], f"frame_{i:04d}.png")
               if run == "A" else os.path.join(
                   run_b["out_dir"],
                   f"frame_{RDV_SAMPLES.index(i):04d}.png"))
        reference[f"run {run} pose {i}"] = lit_compare(
            read_png(png), read_png(os.path.join(ROOT, "misc", name)))
    phase("22 rendezvous",
          "against the JAX package's frames of the same runs (misc/), over "
          "the pixels lit in either: "
          + "; ".join(f"{k} {v['lit_share']:.4%} of the frame, lit "
                      f"{v['lit'][0]} / {v['lit'][1]}, "
                      f"{v['identical']:.4%} identical, mean |d| "
                      f"{v['mean_abs_u8']:.4f}, signed "
                      f"{v['mean_signed_u8']:+.4f} u8"
                      for k, v in reference.items())
          + f" (tolerance: lit counts within {RDV_LIT_COUNT:.0%}, signed "
            f"mean within {RDV_BIAS_U8} u8; at >= {RDV_FULL:.0%} lit also "
            ">= 99% identical and mean |d| <= 0.5 u8)")
    for k, v in reference.items():
        lo, hi = sorted(v["lit"])
        require(lo > 0 and hi <= lo * (1 + RDV_LIT_COUNT)
                and abs(v["mean_signed_u8"]) <= RDV_BIAS_U8
                and (v["lit_share"] < RDV_FULL
                     or (v["identical"] >= 0.99
                         and v["mean_abs_u8"] <= 0.5)),
                f"{k}: the frame differs from the JAX package's")

    # 4. the kernel against its plain version at two of the poses
    cw, ch, cspp = RDV_CHECK
    args_c = driver.build_parser().parse_args(
        rendezvous_args(poses3, run_b["out_dir"], RDV_CHECK))
    ccfg = driver.render_config(args_c)
    checks = {}
    for i in RDV_CHECK_POSES:
        s, cam = driver.frame_inputs(args_c, scene, frames[i], dev)
        img_f, n_f = render_frame_fused(s, cam, ccfg, with_count=True)
        acc_k, n_k = path_kernel.path_render(s, cam, ccfg)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with walk_counter() as wc:
            start.record()
            acc_p, n_p = path_kernel.path_render_plain(s, cam, ccfg, cspp)
            stop.record()
            torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        same = (torch.equal(acc_k, acc_p) and int(n_k) == int(n_p) == n_f
                and bool(np.array_equal(img_f, tonemap(acc_p, ccfg, cspp))))
        work = {k: int(v) for k, v in wc.items()}
        bounds = {}
        for tag, (fw, fh, fspp) in (("run_a", RDV_RUN_A), ("run_b",
                                                            RDV_RUN_B)):
            scale = fw * fh * fspp / (cw * ch * cspp)
            bounds[tag] = roofline_ms(
                scale * (work["visits"] * SLAB_FLOPS
                         + work["tests"] * MT_FLOPS),
                table_bytes(scene, PATH_TABLES) + fw * fh * 3 * 4)
        checks[i] = dict(identical=same, rays=int(n_p), plain_ms=plain_ms,
                         work=work, lit=float((img_f > 0).mean()),
                         bound_ms={k: v[0] for k, v in bounds.items()},
                         bound_by={k: v[1] for k, v in bounds.items()})
        phase("22 rendezvous check",
              f"pose {i} ({sep[i]:.1f} m) {cw}x{ch} spp{cspp} depth"
              f"{ccfg.max_depth}: render_frame_fused against the plain "
              f"version on the card: identical in every pixel and the ray "
              f"count {same} (tolerance: identical), {int(n_p)} rays, lit "
              f"{checks[i]['lit']:.3f}; plain {plain_ms:.1f} ms; "
              f"{work['visits']} binary visits, {work['tests']} triangle "
              f"tests; bound scaled to Run A's frame "
              f"{bounds['run_a'][0]:.4f} ms, to Run B's "
              f"{bounds['run_b'][0]:.4f} ms, by {bounds['run_b'][1]}")
        require(same, f"pose {i}: the path kernel and its plain version "
                      "differ")

    # 5. the driver's issue path at Run A's and Run B's settings waits
    # for nothing on the card
    sw, sh = RDV_SYNC_FRAME
    syncs = {}
    for tag, spp, extra, launches in (
            ("run_a", RDV_RUN_A[2], [], "one launch"),
            ("run_b", RDV_RUN_B[2],
             ["--dispatch_rays", str(RDV_SYNC_RUN_B_RAYS)], "8 launches")):
        args_s = driver.build_parser().parse_args(rendezvous_args(
            poses99, run_a["out_dir"], (sw, sh, spp)) + extra)
        syncs[tag] = issue_syncs(args_s, scene,
                                 [frames[i] for i in RDV_SYNC_POSES], dev)
        phase("22 rendezvous syncs",
              f"{tag}: frame_inputs and render_frame_async at {spp} spp "
              f"on a {sw}x{sh} frame ({launches} a frame), poses "
              f"{list(RDV_SYNC_POSES)}, the second issued while the first "
              f"is in flight: {syncs[tag]} host-device synchronisations "
              f"(tolerance: 0)")
        require(syncs[tag] == 0,
                f"{tag}: the issue path synchronised {syncs[tag]} times")
    result = dict(card=card, poses=n, orbit_cli_s=cli_s,
                  separation_m={i: sep[i] for i in RDV_SAMPLES},
                  run_a=run_a, run_b=dict(run_b, chunk_spp=chunk,
                                          replays=replays),
                  jax_frames=reference, held=held, check=checks,
                  issue_syncs=syncs)
    with open(os.path.join(OUT, "rendezvous.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


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
    from dsrt_tpu_torch.parallel.render import packet_shard
    from dsrt_tpu_torch.render import (render_frame, render_frame_fused,
                                       tonemap)
    from dsrt_tpu_torch.tools.path_probe import random_rays

    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    open(os.path.join(OUT, "phases.log"), "w").close()
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
    # the plain version runs as the pixel lists of phase 21's two dp
    # shards, each under its own counter: the frame's work, and each
    # rank's for its bound
    acc_p32 = torch.empty_like(acc_k32)
    n_p32, p32, shard_work = 0, 0.0, []
    for d in range(SHARD_DP):
        pix, live, _ = packet_shard(800, 450, SHARD_DP, d)
        pix = torch.as_tensor(pix[live], device=dev)
        with walk_counter() as wcd:
            start.record()
            acc_d, n_d = path_kernel.path_render_plain(scene, cam, cfg, 32,
                                                       pixels=pix)
            stop.record()
            torch.cuda.synchronize()
        p32 += start.elapsed_time(stop)
        acc_p32.view(-1, 3)[pix] = acc_d
        n_p32 += int(n_d)
        shard_work.append({k: int(v) for k, v in wcd.items()})
    wc = {k: sum(w[k] for w in shard_work) for k in shard_work[0]}
    kernel_tables = PATH_TABLES
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
                     f"{p32:.1f} ms (the {SHARD_DP} dp shards' lists), "
                     f"accumulators identical on {same32:.4%} "
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
            "dense": dense_block_phase(dev, img, card),
            "pipeline": pipeline_ends_phase(dev, card)}
    with open(os.path.join(OUT, "pipeline_ends.json"), "w") as fh:
        json.dump(ends, fh, indent=1)
    phase("19-20", f"{time.perf_counter() - t0:.0f} s")
    # 21: the sharded renders and the sharded driver
    t0 = time.perf_counter()
    sharded = sharded_phase(dev, card, scene, shard_work, poses, frames)
    with open(os.path.join(OUT, "sharded.json"), "w") as fh:
        json.dump(sharded, fh, indent=1)
    phase("21", f"{time.perf_counter() - t0:.0f} s")
    # 22: the rendezvous sequence through the orbit CLI and the driver
    t0 = time.perf_counter()
    rendezvous = rendezvous_phase(dev, card)
    phase("22", f"{time.perf_counter() - t0:.0f} s")
    # phase 3's launches are microbenchmark launches too; phases 5 and 14
    # (the megakernels' frames, --mode auto's path) required that no
    # traversal kernel was launched; the flagship's sharded sample slices
    # (phase 21) are the main path through the traversal kernels, so the
    # closest and any-hit entries give that frame's waves' time, plain
    # time and bound (means a launch), the split waves' under split_waves
    kernels["dsrt_traverse"]["launches_microbenchmark"] += micro3
    sliced = sharded["flagship sp"]["launches"]
    for walk_kernel in ("dsrt_traverse", "dsrt_traverse any-hit",
                        "dsrt_traverse_sun"):
        kernels[walk_kernel]["launches_main_path"] = sliced[walk_kernel]
    for walk_kernel, query in (("dsrt_traverse", "closest"),
                               ("dsrt_traverse any-hit", "any")):
        e, w = kernels[walk_kernel], sharded["flagship sp"]["waves"][query]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "shape")
        e["split_waves"] = {k: e[k] for k in keys}
        n = w["calls"]
        e.update(ms=w["kernel_ms"] / w["kernel_launches"],
                 wrapper_ms=w["wrapper_ms"] / n, plain_ms=w["plain_ms"] / n,
                 bound_ms=w["bound_ms"] / n, bound_by=w["bound_by"],
                 max_abs_err=w["max_abs_err"],
                 shape=f"flagship 800x450 spp32 depth50 at sp={SHARD_DP}: "
                       f"{n} launches of {w['lanes'] // n} lanes, "
                       f"{w['active']} active in all (means a launch)")
    entry = kernels["dsrt_path_render"]
    entry["frames"] = mixed
    entry["launches_by_frame"] = dict(
        {"flagship": entry["launches"]},
        **{k: v["launches"] for k, v in mixed.items()},
        **{"adaptive flagship": adaptive["dsrt_path_render"]["launches"],
           "pipelined driver, 4 frames":
               pipeline["runs"]["pipelined0"]["launches"],
           "sharded flagship, 1-rank NCCL mesh":
               sharded["flagship 1 rank"]["launches"],
           f"sharded flagship, dp={SHARD_DP} ranks":
               sharded["flagship"]["launches"],
           f"rendezvous Run A, {RDV_POSES} frames":
               rendezvous["run_a"]["launches"]["dsrt_path_render"],
           f"rendezvous Run B, {len(RDV_SAMPLES)} frames":
               rendezvous["run_b"]["launches"]["dsrt_path_render"]})
    entry["launches"] = sum(entry["launches_by_frame"].values())
    entry["pipeline"] = pipeline
    entry["sharded"] = sharded["flagship"]
    # the sequence's summary (its frames are in OUT/rendezvous.json)
    entry["rendezvous"] = dict(
        {k: rendezvous[k] for k in ("poses", "separation_m", "jax_frames",
                                    "held", "check")},
        **{run: {k: v for k, v in rendezvous[run].items()
                 if k not in ("frames", "pngs", "out_dir")}
           for run in ("run_a", "run_b")})
    sph = kernels["dsrt_sphere_render"]
    sph["launches_by_frame"]["adaptive rtiow"] = \
        adaptive["dsrt_sphere_render"]["launches"]
    sph["launches_by_frame"][f"sharded rtiow, dp={SHARD_DP} ranks"] = \
        sharded["rtiow"]["launches"]
    sph["launches"] = sum(sph["launches_by_frame"].values())
    sph["sharded"] = sharded["rtiow"]
    for kname in ("dsrt_path_render", "dsrt_sphere_render"):
        kernels[kname]["list_launch"] = dict(check=lists[kname],
                                             adaptive=adaptive[kname])
    trav = kernels["dsrt_traverse"]
    trav["launches_by_path"] = {
        "split frames": trav["launches"],
        "debug frames": sum(debug[k]["launches"]
                            for k in ("solid", "gradient")),
        "radiance": debug["radiance"]["launches"]}
    for walk_kernel in ("dsrt_traverse any-hit", "dsrt_traverse_sun"):
        kernels[walk_kernel]["launches_by_path"] = {
            "split frames": kernels[walk_kernel]["launches"]}
    for walk_kernel in ("dsrt_traverse", "dsrt_traverse any-hit",
                        "dsrt_traverse_sun"):
        e = kernels[walk_kernel]
        e["launches_by_path"][f"sharded sp={SHARD_DP} ranks"] = \
            sliced[walk_kernel]
        e["launches"] = sum(e["launches_by_path"].values())
    trav["debug"] = debug

    require("jax" not in sys.modules, "jax was imported")
    require(not [m for m in sys.modules
                 if m == "dsrt_tpu" or m.startswith("dsrt_tpu.")],
            "the JAX package was imported")
    phase("done", f"{time.perf_counter() - t_start:.0f} s")
    line = json.dumps({"kernels": list(kernels.values())})
    with open(os.path.join(OUT, "kernels.json"), "w") as fh:
        fh.write(line + "\n")
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
