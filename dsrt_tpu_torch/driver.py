"""Frame-loop driver and CLI (port of dsrt_tpu/driver.py).

Per frame: pose -> float64 world->model transform -> camera aim ->
path-kernel render -> PNG.  The scene is compiled once; each frame only
swaps the sun direction (`Scene.with_sun`).

Usage:
    python -m dsrt_tpu_torch.driver --input_txt poses.txt --output_dir out \
        [--obj mesh.obj | --standin_detail 2 --standin_tex panel.png] \
        [--width 800 --height 450] [--spp 1000] [--device cuda]

`--device cuda` (the default) runs the CUDA path kernel and fails when no
CUDA device is present; `--device cpu` runs the plain PyTorch version.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from dsrt_tpu.config import RenderConfig
from dsrt_tpu.models.materials import Material
from dsrt_tpu.utils.image_io import write_png, write_ppm
from dsrt_tpu.utils.pose import default_pose, read_pose_file
from dsrt_tpu.utils.timing import StageTimer, mrays_per_sec
from dsrt_tpu.utils.transform import pose_to_frame
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.render import render_frame_fused


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsrt_tpu_torch.driver",
        description="Deep-space ray tracer frame-loop driver (PyTorch/CUDA)")
    p.add_argument("--input_txt", default="",
                   help="pose file (orbit sim output)")
    p.add_argument("--output_dir", default="render_output")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--spp", type=int, default=1000)
    p.add_argument("--max_depth", type=int, default=50)
    p.add_argument("--vfov", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--gamma", type=float, default=2.0)
    p.add_argument("--sun_radiance", type=float, nargs=3,
                   default=[1e5, 9.5e4, 9e4])
    p.add_argument("--obj", default="", help="OBJ mesh path (model frame)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--standin_tex", default="",
                   help="image texture for the stand-in mesh's panel and "
                        "radiator quads")
    p.add_argument("--standin_detail", type=int, default=2,
                   help="procedural ISS stand-in detail when no --obj")
    p.add_argument("--bvh", choices=["median", "sah", "sbvh"],
                   default="sbvh", help="BVH builder")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose PNG already exists")
    p.add_argument("--wipe", action="store_true",
                   help="empty the output dir first")
    p.add_argument("--save_ppm", action="store_true",
                   help="also write binary PPM P6")
    p.add_argument("--timings_tsv", default="",
                   help="write per-stage timings TSV here")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the path kernel) or cpu "
                        "(the plain version)")
    return p


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain version)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def build_scene(args, timer: StageTimer, device):
    with timer.stage("mesh_load"):
        if args.obj:
            from dsrt_tpu.models.obj import load_obj
            mesh = load_obj(args.obj, Material.lambertian((0.73, 0.73, 0.73)),
                            args.scale)
        else:
            from dsrt_tpu.models.mesh_gen import iss_standin_mesh
            mesh = iss_standin_mesh(args.standin_detail,
                                    tex_path=args.standin_tex)
    with timer.stage("scene_compile"):
        b = SceneBuilder(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0),
                         sun_radiance=tuple(args.sun_radiance),
                         seed=args.seed, bvh_method=args.bvh)
        b.add_mesh(mesh)
        scene = b.build(device=device)
    print(f"Scene: {scene.n_tris} triangles, {scene.n_nodes} BVH nodes, "
          f"{scene.mat_pack.shape[0]} materials")
    return scene


def run(args) -> int:
    device = resolve_device(args.device)
    timer = StageTimer()
    os.makedirs(args.output_dir, exist_ok=True)
    if args.wipe:
        for f in os.listdir(args.output_dir):
            fp = os.path.join(args.output_dir, f)
            if os.path.isfile(fp):
                os.unlink(fp)

    print(f"Using input_txt : {args.input_txt or '(none)'}")
    print(f"Using output_dir: {args.output_dir}")
    scene = build_scene(args, timer, device)
    print(timer.summary())

    poses = []
    if args.input_txt:
        try:
            poses = read_pose_file(args.input_txt)
        except OSError:
            poses = []
    if not poses:
        print("No valid pose file found; using single default pose.")
        poses = [default_pose()]
    else:
        print(f"Loaded {len(poses)} poses.")

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, vfov=args.vfov,
                       gamma=args.gamma, seed=args.seed)
    total_start = time.perf_counter()
    rendered = 0
    for i, pose in enumerate(poses):
        if i < args.start_frame:
            continue
        png = os.path.join(args.output_dir, f"frame_{i:04d}.png")
        if args.resume and os.path.exists(png):
            continue
        frame = pose_to_frame(pose)
        if frame is None:
            print(f"[{i}] camera inside/too close to model; skipping frame.")
            continue
        print(f"\n=== Frame {i} ===")
        print(f"  sep(cam, model) = {frame.separation_m:.3f} m")
        print(f"  sun_dir_model   = ({frame.sun_dir_model[0]:.6f}, "
              f"{frame.sun_dir_model[1]:.6f}, {frame.sun_dir_model[2]:.6f})")
        cam = point_camera_at(frame.cam_in_model, (0.0, 0.0, 0.0),
                              vfov=args.vfov, width=args.width,
                              height=args.height, device=device)
        frame_scene = scene.with_sun(frame.sun_dir_model)
        t0 = time.perf_counter()
        img, nrays = render_frame_fused(frame_scene, cam, cfg,
                                        with_count=True)
        dt = time.perf_counter() - t0
        timer.log("render", dt)
        print(f"  render: {dt*1e3:.0f} ms  ({mrays_per_sec(nrays, dt):.1f} "
              f"Mrays/s on {device.type}, {nrays} rays exact)")
        with timer.stage("encode"):
            write_png(png, img)
            if args.save_ppm:
                write_ppm(png[:-4] + ".ppm", img)
        print(f"Saved {png}")
        rendered += 1

    total = time.perf_counter() - total_start
    print(f"\nTotal runtime: {total:.1f} s ({rendered} frames)")
    if args.timings_tsv:
        timer.write_tsv(args.timings_tsv)
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
