"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dsrt_tpu_torch/csrc/, holds each against its
plain PyTorch version, renders the flagship frame (textured ISS stand-in,
51k triangles, 800x450, 32 spp, max_depth 50, sun on) through
`render_frame_fused`, and runs the frame-loop driver over two poses.  Each
phase prints one line; any failure raises, so the exit code is nonzero.
The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.  Needs one CUDA device; imports no JAX.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dsrt_tpu.config import RenderConfig
    from dsrt_tpu_torch import driver
    from dsrt_tpu_torch.models.mesh_gen import (iss_standin_scene,
                                                write_panel_texture)
    from dsrt_tpu_torch.ops import build, path_kernel
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.ops.trace import lane_traverse
    from dsrt_tpu_torch.render import (render_frame, render_frame_fused,
                                       tonemap)

    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)

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
    regs = [ln.strip() for ln in build.build_info["log"].splitlines()
            if "registers" in ln]
    phase("2 build", f"{time.perf_counter() - t0:.1f} s "
                     f"(nvcc {build.build_info['seconds']:.1f} s); "
                     + " | ".join(regs))

    with tempfile.TemporaryDirectory() as td:
        tex = os.path.join(td, "panel.png")
        write_panel_texture(tex)
        t0 = time.perf_counter()
        scene_cpu = iss_standin_scene(detail=12, tex_path=tex)
    scene = scene_cpu.to(dev)
    require(scene.n_tris > 50000 and scene.has_image_tex, "flagship scene")
    phase("scene", f"{scene.n_tris} triangles, {scene.n_nodes} nodes, "
                   f"{scene.n_textures} texture, built in "
                   f"{time.perf_counter() - t0:.1f} s")
    kernels = {}

    # 3. closest hit: kernel vs the plain walk, 2^20 rays, exact
    ro, rd = random_rays(1 << 20, 3, dev)
    act = torch.ones(ro.x.shape, dtype=torch.bool, device=dev)
    t_k = event_ms(lambda: path_kernel.closest_hit(scene, ro, rd), 10)
    t_p = event_ms(lambda: lane_traverse(scene, ro, rd, 1e-3, 1e9, act), 1)
    hit_k = path_kernel.closest_hit(scene, ro, rd)
    hit_p = lane_traverse(scene, ro, rd, 1e-3, 1e9, act)
    mism = int(((hit_k[3] != hit_p[3]) | (hit_k[0] != hit_p[0])
                | (hit_k[1] != hit_p[1]) | (hit_k[2] != hit_p[2])).sum())
    hits = int((hit_k[3] >= 0).sum())
    phase("3 closest hit", f"2^20 rays, {hits} hits, {mism} mismatches in "
                           f"(t,u,v,tri) (tolerance: exact); kernel "
                           f"{t_k:.3f} ms, plain {t_p:.1f} ms")
    require(mism == 0 and hits > 0, "closest-hit kernel disagrees")

    # 4. frame check: the path kernel vs the plain renderer on CPU copies
    cfg_s = RenderConfig(width=64, height=36, spp=2, max_depth=8)
    cam_s = point_camera_at(SUNLIT_CAM, vfov=cfg_s.vfov, width=64,
                            height=36)
    acc_k, n_k = path_kernel.path_render(scene, cam_s.to(dev), cfg_s)
    img_k = tonemap(acc_k, cfg_s, cfg_s.spp)
    img_p, n_p = render_frame(scene_cpu, cam_s, cfg_s, with_count=True)
    acc_p, _ = path_kernel.path_render_plain(scene_cpu, cam_s, cfg_s,
                                             cfg_s.spp)
    diff = np.abs(img_k.astype(int) - img_p.astype(int))
    same = float((diff.max(-1) == 0).mean())
    mean_d = float(diff.mean())
    n_k = int(n_k)
    max_abs = float((acc_k.cpu() - acc_p).abs().max())
    phase("4 frame check", f"64x36 spp2 depth8: {same:.4%} pixels identical,"
                           f" mean |d| {mean_d:.4f} u8, max |d| {diff.max()}"
                           f" u8, accum max |d| {max_abs:.3g}; rays kernel "
                           f"{n_k} plain {n_p} (tolerance: >= 98% identical,"
                           f" mean <= 1 u8, rays within 1%)")
    require(same >= 0.98 and mean_d <= 1.0, "path kernel disagrees")
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
    secs, times, (img, rays) = wall_time(
        lambda: render_frame_fused(scene, cam, cfg, with_count=True), 3)
    launches = dict(path_kernel.LAUNCHES)
    phase("5 flagship", f"800x450 spp32 depth50: {secs:.4f} s (reps "
                        f"{', '.join(f'{t:.4f}' for t in times)}), {rays} "
                        f"rays exact, {rays / secs / 1e6:.2f} Mrays/s, "
                        f"launches {launches}")
    require(launches["dsrt_path_render"] > 0, "path kernel not launched")
    require(img.shape == (450, 800, 3) and img.max() > 0, "flagship image")
    require(rays >= 800 * 450 * 32, "ray count below one per sample")

    # the kernel alone, and kernel vs plain at the flagship frame, 1 spp
    k32 = event_ms(lambda: path_kernel.path_render(scene, cam, cfg), 5)
    cfg1 = dataclasses.replace(cfg, spp=1)
    k1 = event_ms(lambda: path_kernel.path_render(scene, cam, cfg1), 10)
    p1 = event_ms(lambda: path_kernel.path_render_plain(scene, cam, cfg1, 1),
                  1)
    acc_k1, n_k1 = path_kernel.path_render(scene, cam, cfg1)
    acc_p1, n_p1 = path_kernel.path_render_plain(scene, cam, cfg1, 1)
    err1 = float((acc_k1 - acc_p1).abs().max())
    same1 = float((acc_k1 == acc_p1).all(dim=-1).float().mean())
    phase("5 times", f"kernel alone 800x450 spp32: {k32:.3f} ms "
                     f"({rays / k32 / 1e3:.1f} Mrays/s); 800x450 spp1 "
                     f"depth50: kernel {k1:.3f} ms, plain {p1:.1f} ms; "
                     f"accumulators identical on {same1:.4%} of pixels, "
                     f"max |d| {err1:.3g}, rays {int(n_k1)} vs {int(n_p1)}")
    require(same1 >= 0.98
            and abs(int(n_k1) - int(n_p1)) <= 0.01 * int(n_p1),
            "kernel and plain disagree at the flagship frame")
    kernels["dsrt_path_render"] = {
        "name": "dsrt_path_render", "route": "cuda",
        "source": "dsrt_tpu_torch/csrc/path_kernel.cu",
        "replaces": "dsrt_tpu/ops/pallas_path.py:477",
        "launches": launches["dsrt_path_render"],
        "max_abs_err": err1, "ms": k1, "plain_ms": p1,
        "shape": "800x450 spp1 max_depth50", "frame_ms": secs * 1e3,
        "frame_kernel_ms": k32, "mrays_per_s": rays / secs / 1e6}

    # 6. the driver over two poses
    poses = os.path.join(OUT, "poses.txt")
    from dsrt_tpu.utils.pose import write_pose_file
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
    from dsrt_tpu.utils.image_io import read_png
    pngs = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    lit = [float((read_png(os.path.join(frames, f)) > 0).mean())
           for f in pngs]
    phase("6 driver", f"rc {rc}, frames {pngs}, lit shares {lit}")
    require(rc == 0 and len(pngs) == 2 and min(lit) > 0, "driver frames")

    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
