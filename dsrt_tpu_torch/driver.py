"""Frame-loop driver and CLI (port of dsrt_tpu/driver.py).

Per frame: pose -> float64 world->model transform -> camera aim ->
render -> PNG.  The scene is compiled once; each frame only swaps the sun
direction (`Scene.with_sun`).  `--debug_shade` renders the flat-shade
debug frame (`render_frame_debug`, sky from `--sky`); `--adaptive TOL`
renders split-buffer rounds over the active pixels
(`render_frame_adaptive`, `--spp` the cap, `--adaptive_chunk` samples a
round); otherwise `--mode` picks the renderer as the JAX driver does
(dsrt_tpu/driver.py:317-350): `auto` takes the megakernel that covers the
scene (`fused_kind`) and the split pipeline (`render_frame_wavefront`)
for every other scene; `fused` falls back to wavefront the same way, with
a note; `parity`, `wavefront` and `queue` force a renderer.  Wavefront's
sample slots halve until they divide spp.  `--dispatch_rays` is the
fused frames' per-launch primary-ray budget (0: never chunk).

Fused and wavefront frames are issued with `render_frame_async` and
pipelined unless `--no_pipeline`: frame n is issued before frame n-1 is
waited for and encoded, so the card renders one frame while the host
encodes the one before; with `--no_pipeline` each frame is waited for
and encoded before the next is issued.  The PNG bytes are the same
either way.  `--profile DIR` writes a
torch.profiler trace of the first rendered frame to DIR/trace.json.
`--upscale` then runs the super-resolution post-process over the output
directory into `<output_dir>_upscaled` (scripts/upsample.py
`process_folder`, x4, backend auto: the RRDBNet on cached weights, else
bicubic) on the same device; a failed upscale fails the run.

The JAX driver's TPU execution knobs (`--block_h`, `--pallas`, `--pops`,
`--sun_pops`) are refused with an error: they set Pallas mechanism the
port does not have (docs/MIGRATION.md).

Usage:
    python -m dsrt_tpu_torch.driver --input_txt poses.txt --output_dir out \
        [--obj mesh.obj [--smooth] | --standin_detail 2 \
         --standin_tex panel.png] [--env_map sky.hdr --env_rotation 0 \
         --env_scale 1] [--width 800 --height 450] [--spp 1000] \
        [--device cuda] \
        [--mode auto|fused|parity|wavefront|queue] [--spp_batch 8] \
        [--adaptive 0.02 [--adaptive_chunk 4]] [--debug_shade \
         [--sky solid|gradient]] [--no_pipeline] [--dispatch_rays N] \
        [--profile trace_dir] [--upscale]

`--device cuda` (the default) runs the CUDA kernels and fails when no
CUDA device is present; `--device cpu` runs their plain PyTorch
versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from dsrt_tpu_torch import device as devices
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.utils.image_io import write_png, write_ppm
from dsrt_tpu_torch.utils.pose import default_pose, read_pose_file
from dsrt_tpu_torch.utils.timing import StageTimer, mrays_per_sec
from dsrt_tpu_torch.utils.transform import pose_to_frame
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.render import (FUSED_DISPATCH_RAYS, finish, fused_kind,
                                   render_frame, render_frame_adaptive,
                                   render_frame_async, render_frame_debug,
                                   render_frame_queue)


# the JAX driver's TPU execution knobs (dsrt_tpu/driver.py:120-138)
TPU_FLAGS = ("--block_h", "--pallas", "--pops", "--sun_pops")


class RefuseTPUFlag(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} sets TPU kernel mechanism that the "
                     "PyTorch/CUDA port does not have; see "
                     "docs/MIGRATION.md")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsrt_tpu_torch.driver",
        description="Deep-space ray tracer frame-loop driver (PyTorch/CUDA)")
    p.add_argument("--input_txt", default="",
                   help="pose file (orbit sim output)")
    p.add_argument("--output_dir", default="render_output")
    p.add_argument("--upscale", action="store_true",
                   help="run the super-resolution upsampler (x4) over the "
                        "output dir into <output_dir>_upscaled")
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
    p.add_argument("--smooth", action="store_true",
                   help="honour the OBJ's vn normals (smooth shading; flat "
                        "by default)")
    p.add_argument("--standin_tex", default="",
                   help="image texture for the stand-in mesh's panel and "
                        "radiator quads")
    p.add_argument("--standin_detail", type=int, default=2,
                   help="procedural ISS stand-in detail when no --obj")
    p.add_argument("--bvh", choices=["median", "sah", "sbvh"],
                   default="sbvh", help="BVH builder")
    p.add_argument("--env_map", default="",
                   help="equirect environment-map image for the sky (.hdr "
                        "stays linear radiance); black without one")
    p.add_argument("--env_rotation", type=float, default=0.0,
                   help="env map rotation about +y [deg]")
    p.add_argument("--env_scale", type=float, default=1.0,
                   help="env radiance multiplier")
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
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--mode",
                   choices=["auto", "fused", "parity", "wavefront", "queue"],
                   default="auto",
                   help="auto: the megakernel when one covers the scene, "
                        "else wavefront. fused: one megakernel launch a "
                        "frame. parity: the sequential per-pixel sample "
                        "loop. wavefront: the split pipeline with per-lane "
                        "regeneration. queue: the split pipeline as one "
                        "global work queue (auto-bands huge frames).")
    p.add_argument("--spp_batch", type=int, default=8,
                   help="concurrent sample slots per pixel (wavefront)")
    p.add_argument("--adaptive", type=float, default=0.0,
                   help="adaptive sampling tolerance (> 0 enables; --spp "
                        "becomes the per-pixel cap; split-buffer "
                        "convergence, scenes a megakernel covers)")
    p.add_argument("--adaptive_chunk", type=int, default=0,
                   help="samples per adaptive round (0: max(4, spp / 8))")
    p.add_argument("--no_pipeline", action="store_true",
                   help="render and encode each frame in turn (by default "
                        "fused and wavefront frames are issued one frame "
                        "ahead of the encode)")
    p.add_argument("--debug_shade", action="store_true",
                   help="flat-shade debug render: albedo x texture, lights "
                        "white, the sky on a miss")
    p.add_argument("--sky", choices=["solid", "gradient"], default="solid",
                   help="debug-shade sky")
    p.add_argument("--dispatch_rays", type=int, default=None,
                   help="primary rays per megakernel launch; frames above "
                        "it render as salted spp chunks (default "
                        f"{FUSED_DISPATCH_RAYS}; 0: never chunk)")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the first "
                        "rendered frame to this directory (trace.json)")
    for flag in TPU_FLAGS:
        p.add_argument(flag, action=RefuseTPUFlag,
                       help="TPU kernel mechanism of the JAX driver; "
                            "refused here (docs/MIGRATION.md)")
    return p


def resolve_mode(mode: str, scene, cfg) -> str:
    """The renderer `--mode` runs on this scene (the JAX driver's
    dispatch): auto and fused take the megakernel that covers the scene,
    else wavefront."""
    if mode in ("auto", "fused"):
        if fused_kind(scene, cfg) is not None:
            return "fused"
        if mode == "fused":
            print("  fused mode unsupported for this scene; falling back "
                  "to wavefront")
        return "wavefront"
    return mode


def render(mode: str, scene, cam, cfg):
    """(u8 image, exact ray count or None) of one parity or queue frame
    (fused and wavefront frames go through render_frame_async)."""
    if mode == "queue":
        return render_frame_queue(scene, cam, cfg), None
    return render_frame(scene, cam, cfg, with_count=True)


def start_profile(device: torch.device):
    """A running torch.profiler session (CPU, and CUDA on the card)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profile(prof, out_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"  profiler trace written to {path}")


def finish_frame(pending, timer: StageTimer, args) -> None:
    """Wait for an issued frame, then encode it."""
    idx, png, frame, t0, label = pending
    img, nrays = finish(frame)
    dt = time.perf_counter() - t0   # issue -> on the host
    timer.log("render", dt)
    print(f"  [frame {idx}] render ({label}) + wait: {dt*1e3:.0f} ms, "
          f"{mrays_per_sec(nrays, dt):.1f} Mrays/s, {nrays} rays exact")
    encode(png, img, timer, args)


def encode(png: str, img, timer: StageTimer, args) -> None:
    with timer.stage("encode"):
        write_png(png, img)
        if args.save_ppm:
            write_ppm(png[:-4] + ".ppm", img)
    print(f"Saved {png}")


def resolve_device(name: str) -> torch.device:
    dev = devices.resolve_device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def build_scene(args, timer: StageTimer, device):
    with timer.stage("mesh_load"):
        if args.obj:
            from dsrt_tpu_torch.models.obj import load_obj
            mesh = load_obj(args.obj, Material.lambertian((0.73, 0.73, 0.73)),
                            args.scale, smooth=args.smooth)
        else:
            from dsrt_tpu_torch.models.mesh_gen import iss_standin_mesh
            mesh = iss_standin_mesh(args.standin_detail,
                                    tex_path=args.standin_tex)
    with timer.stage("scene_compile"):
        b = SceneBuilder(sun_enabled=True, sun_dir=(0.0, 1.0, 0.0),
                         sun_radiance=tuple(args.sun_radiance),
                         seed=args.seed, bvh_method=args.bvh)
        b.add_mesh(mesh)
        if args.env_map:
            b.set_environment(args.env_map, rotation_deg=args.env_rotation,
                              scale=args.env_scale)
        scene = b.build(device=device)
    print(f"Scene: {scene.n_tris} triangles, {scene.n_nodes} BVH nodes, "
          f"{scene.n_spheres} spheres, {scene.mat_pack.shape[0]} materials"
          f"{', smooth' if scene.has_smooth else ''}"
          f"{', env sky' if scene.has_env else ''}")
    return scene


def run(args, scene=None) -> int:
    """Render every pose of the pose file; `scene` (compiled on the
    device of --device) replaces the scene the mesh flags describe."""
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
    if scene is None:
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
                       gamma=args.gamma, seed=args.seed, sky_type=args.sky)
    budget = (FUSED_DISPATCH_RAYS if args.dispatch_rays is None
              else args.dispatch_rays)
    total_start = time.perf_counter()
    rendered = 0
    pending = None   # the issued frame not yet encoded (pipeline)
    prof = None
    profiled = not args.profile
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
        if not profiled:
            prof, profiled = start_profile(device), True
        t0 = time.perf_counter()
        issued = None
        if args.debug_shade:
            label = "debug"
            img, nrays = render_frame_debug(frame_scene, cam, cfg), None
        elif args.adaptive > 0:
            label = "adaptive"
            img, stats = render_frame_adaptive(
                frame_scene, cam, cfg, tol=args.adaptive,
                chunk_spp=args.adaptive_chunk or None, with_count=True)
            nrays = stats["rays"]
            print(f"  [frame {i}] adaptive: mean spp {stats['mean_spp']:.1f}"
                  f"/{cfg.spp} over {stats['rounds']} rounds")
        else:
            label = resolve_mode(args.mode, frame_scene, cfg)
            if label in ("fused", "wavefront"):
                issued = render_frame_async(frame_scene, cam, cfg, mode=label,
                                            spp_batch=args.spp_batch,
                                            budget=budget)
            else:
                img, nrays = render(label, frame_scene, cam, cfg)
        label = f"{label} on {device.type}"
        if prof is not None:
            if issued is not None and issued.done is not None:
                issued.done.synchronize()
            stop_profile(prof, args.profile)
            prof = None
        if issued is not None:
            # encode the previous frame while this one renders
            if pending is not None:
                finish_frame(pending, timer, args)
                rendered += 1
            pending = (i, png, issued, t0, label)
            if args.no_pipeline:
                finish_frame(pending, timer, args)
                rendered += 1
                pending = None
            continue
        dt = time.perf_counter() - t0
        timer.log("render", dt)
        rays = ("" if nrays is None else
                f", {mrays_per_sec(nrays, dt):.1f} Mrays/s, {nrays} rays "
                "exact")
        print(f"  render ({label}): {dt*1e3:.0f} ms{rays}")
        encode(png, img, timer, args)
        rendered += 1
    if pending is not None:
        finish_frame(pending, timer, args)
        rendered += 1

    total = time.perf_counter() - total_start
    print(f"\nTotal runtime: {total:.1f} s ({rendered} frames)")
    if args.timings_tsv:
        timer.write_tsv(args.timings_tsv)

    if args.upscale:
        from dsrt_tpu_torch.scripts.upsample import process_folder
        process_folder(args.output_dir, args.output_dir + "_upscaled",
                       scale=4, device=device)
    else:
        print("Upscaling disabled (use --upscale to enable).")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
