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

Every mode hands the loop a `render.PendingFrame` (`issue_frame`), and
`finish_frame` alone waits for it, prints its line (`[frame i] render
(<label> on <device>) + wait: ...`, with Mrays/s and the exact rays
where the renderer counts them), encodes it and runs the upscale stage.
Fused and wavefront frames come from `render_frame_async` and are
pipelined unless `--no_pipeline`: frame n is issued before frame n-1 is
finished.  On the card nothing in a frame's inputs or issue waits for
the device (its camera and sun go up in copies that queue on the
stream), so frame n queues behind frame n-1 while the host encodes; at
most two frames are on the card.  A frame complete when issued (the
other modes, any CPU frame) is finished at once, as is every frame with
`--no_pipeline`; the PNG bytes are the same either way.  `--profile
DIR` writes a torch.profiler trace of the first rendered frame to
DIR/trace.json.

`--timings_tsv PATH` writes the run's spans (utils/timing.py), one row a
span (`stage`, `duration_ns`, `frame`: the pose-line index i of
`frame_{i:04d}.png`, -1 outside a frame): `run` (the whole loop, up to
the TSV), `mesh_load` and `scene_compile` (unless a scene is passed in),
and per frame, in every mode, `inputs` (`frame_inputs`: camera and sun
on the device), `issue` (the render call: for fused and wavefront frames
`render_frame_async`, which returns before the card is done), one
`launch` a path-kernel call (ops/path_kernel.py `path_render`), `wait`
(`render.finish`: with the pipeline, the wait for the frame in flight,
which `inputs` does not hold; about zero for a frame complete when
issued), `encode`, and the row `render`, from issue to the image on the
host, which overlaps the encode of the frame before.  While a torch
profiler runs, each span but `render` is also a `record_function`
annotation of the same name.

`--upscale` runs the x4 super-resolution stage inside the frame loop, on
the same device: each frame, once its PNG is encoded, is upscaled from
the image in hand into `<output_dir>_upscaled/frame_{i:04d}.png`.  The
backend (scripts/upsample.py `Upscaler`) is loaded once a run, at the
first frame's stage (span `upscale_load`, frame -1, after
`<output_dir>_upscaled` is made): with `--upscale_weights PATH` the
RRDBNet on that checkpoint, and a file that is missing or does not load
fails the run there, with nothing fetched and no fallback; without it
the release weights' lookup (`fetch_weights`), else bicubic, as
`scripts.upsample` does.  Frame i's stage issues its upscale (span
`upscale`: `Upscaler.issue`, the network's `models/esrgan.py`
`upscale_u8_async`, whose tile batches are spans `upscale_forward`; on
the card nothing there waits for the device), and only then finishes
frame i-1's (span `upscale_finish`: the wait for its copy back, and the
stitch), so the card runs frame i's forward while the host stitches and
writes frame i-1 and renders, encodes and tiles frame i+1.  A frame
finished with nothing queued behind it, each frame with `--no_pipeline`
and the last at the loop's end, is span `upscale_drain`.  The upscaled
PNG is written on a thread of its own, one write in flight; its row
`upscale_encode` is recorded when the loop waits for it (before the
next write, and at the loop's end), and is no profiler annotation.  A
failed stage fails the run.  `--resume` with `--upscale` skips a frame
only when its upscaled PNG exists.

`--shard` makes the process one rank of a torch.distributed.run group
(parallel/mesh.py: NCCL when every rank has a card of its own, gloo when
ranks share one or run on the CPU): after `--debug_shade` and before
`--adaptive` and `--mode`, each frame renders across an ("sp", "dp")
mesh of every rank with `--shard_sp` sample slices
(dsrt_tpu/driver.py:290-306): dp only on a scene a megakernel covers,
`render_frame_fused_sharded` (each rank's pixel shard one list launch),
else `render_frame_sharded` (the traversal kernels).  Sharded frames are
not pipelined; rank 0 alone prints to stdout, writes the PNG, PPM and
TSV, and runs the `--upscale` stage.  `--hosts N --host_id I` renders
(and upscales) only frames i with i % N == I (independent processes, no
collectives); it applies before any other frame filter.

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
        [--profile trace_dir] [--upscale [--upscale_weights ckpt.pth]] \
        [--hosts 2 --host_id 0]
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m dsrt_tpu_torch.driver --shard [--shard_sp S] ...

`--device cuda` (the default) runs the CUDA kernels and fails when no
CUDA device is present; `--device cpu` runs their plain PyTorch
versions.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from dsrt_tpu_torch import device as devices
from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.models.materials import Material
from dsrt_tpu_torch.utils import image_io
from dsrt_tpu_torch.utils.pose import default_pose, read_pose_file
from dsrt_tpu_torch.utils import timing
from dsrt_tpu_torch.utils.timing import StageTimer, mrays_per_sec
from dsrt_tpu_torch.utils.transform import pose_to_frame
from dsrt_tpu_torch.models.scene import SceneBuilder
from dsrt_tpu_torch.ops.camera import point_camera_at
from dsrt_tpu_torch.render import (FUSED_DISPATCH_RAYS, PendingFrame,
                                   finish, fused_kind, render_frame,
                                   render_frame_adaptive, render_frame_async,
                                   render_frame_debug, render_frame_queue)


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
                   help="upscale each frame x4 (super-resolution) into "
                        "<output_dir>_upscaled, inside the frame loop")
    p.add_argument("--upscale_weights", default="",
                   help="the RRDBNet checkpoint --upscale runs (basicsr "
                        "layout); a missing or unreadable file fails the "
                        "run. Without it: the cached release weights, "
                        "else a download, else bicubic")
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
    p.add_argument("--shard", action="store_true",
                   help="shard the render across all ranks (torch."
                        "distributed.run; mesh ('sp','dp') + all-reduce; "
                        "dp-only sharding is bit-identical to one process)")
    p.add_argument("--shard_sp", type=int, default=1,
                   help="sample-parallel axis size (must divide ranks & spp)")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--hosts", type=int, default=1,
                   help="multi-host frame distribution: total host count "
                        "(frames are independent, so hosts round-robin "
                        "with no collectives)")
    p.add_argument("--host_id", type=int, default=0,
                   help="this host's index in [0, --hosts)")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose PNG (with --upscale: upscaled "
                        "PNG) already exists")
    p.add_argument("--wipe", action="store_true",
                   help="empty the output dir first")
    p.add_argument("--save_ppm", action="store_true",
                   help="also write binary PPM P6")
    p.add_argument("--timings_tsv", default="",
                   help="write the run's spans here as a TSV: stage, "
                        "duration_ns, frame (the frame id, -1 outside a "
                        "frame)")
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


class UpscaleStage:
    """`--upscale` inside the frame loop: `stage(png, img, i, timer)`
    issues frame i's x4 upscale, then finishes the frame issued before
    (all of them with --no_pipeline), whose image is written to
    `<output_dir>_upscaled` under its frame's PNG name.  The backend is
    loaded at the first call.  The write runs on a thread of its own
    (zlib lets go of the interpreter lock), one write in flight at most;
    `close` finishes the frame left and waits for the last write."""

    def __init__(self, args, device):
        self.out_dir = args.output_dir + "_upscaled"
        self.weights = args.upscale_weights or None
        self.pipeline = not args.no_pipeline
        self.device = device
        self.up = None
        self.writer = None
        self.issued = None    # (PendingUpscale, PNG, frame id) unfinished
        self.writing = None   # (future of the write, its frame id)

    def final(self, png: str) -> str:
        """The upscaled PNG of the frame whose PNG is `png`."""
        return os.path.join(self.out_dir, os.path.basename(png))

    def __call__(self, png: str, img, frame: int, timer: StageTimer):
        if self.up is None:
            from dsrt_tpu_torch.scripts.upsample import Upscaler
            os.makedirs(self.out_dir, exist_ok=True)
            with timer.stage("upscale_load", frame=-1):
                self.up = Upscaler(4, device=self.device,
                                   weights=self.weights)
            print(f"Upscaling x4 via {self.up.backend} -> {self.out_dir}")
            self.writer = ThreadPoolExecutor(
                1, thread_name_prefix="upscale_encode")
        with timer.stage("upscale", frame=frame):
            issued = (self.up.issue(img), png, frame)
        if self.issued is not None:
            self.finish(timer, "upscale_finish")
        self.issued = issued
        if not self.pipeline:
            self.finish(timer, "upscale_drain")

    def finish(self, timer: StageTimer, span: str) -> None:
        """Wait for the issued frame's image (span `span`) and hand it
        to the writer once the write in flight is done."""
        from dsrt_tpu_torch.models.esrgan import finish_upscale
        pending, png, frame = self.issued
        self.issued = None
        with timer.stage(span, frame=frame):
            out = finish_upscale(pending)
        self.wait(timer)
        self.writing = (self.writer.submit(self._write, timer,
                                           self.final(png), out), frame)

    @staticmethod
    def _write(timer: StageTimer, path: str, img):
        t0 = timer.now()
        image_io.write_png(path, img)
        return t0, timer.now()

    def wait(self, timer: StageTimer) -> None:
        """Wait for the write in flight, if any (its error raises here),
        and record it as the row `upscale_encode`."""
        if self.writing is not None:
            future, frame = self.writing
            self.writing = None
            t0, t1 = future.result()
            timer.log("upscale_encode", t0, frame=frame, end_ns=t1)

    def close(self, timer: StageTimer) -> None:
        """Finish the frame left, wait for the last write and let the
        writer's thread go."""
        if self.issued is not None:
            self.finish(timer, "upscale_drain")
        if self.writer is not None:
            self.wait(timer)
            self.writer.shutdown()


def issue_frame(args, idx: int, scene, cam, cfg, mesh, budget: int):
    """(label, PendingFrame) of frame `idx`, by the first that applies:
    --debug_shade, --shard, --adaptive, then the renderer --mode
    resolves to.  Fused and wavefront frames come from
    render_frame_async and may still be on the card; the others are
    complete."""
    if args.debug_shade:
        return "debug", PendingFrame(render_frame_debug(scene, cam, cfg))
    if mesh is not None:
        from dsrt_tpu_torch.parallel.render import (
            render_frame_fused_sharded, render_frame_sharded)
        over = f" over {mesh.sp}x{mesh.dp} ranks"
        if args.shard_sp == 1 and fused_kind(scene, cfg):
            # dp only: every rank runs the megakernel on its pixel shard
            # (bit-identical to one process)
            return "fused sharded" + over, PendingFrame(
                *render_frame_fused_sharded(scene, cam, cfg, mesh,
                                            with_count=True))
        return "sharded" + over, PendingFrame(
            render_frame_sharded(scene, cam, cfg, mesh))
    if args.adaptive > 0:
        img, stats = render_frame_adaptive(
            scene, cam, cfg, tol=args.adaptive,
            chunk_spp=args.adaptive_chunk or None, with_count=True)
        print(f"  [frame {idx}] adaptive: mean spp "
              f"{stats['mean_spp']:.1f}/{cfg.spp} over {stats['rounds']} "
              "rounds")
        return "adaptive", PendingFrame(img, stats["rays"])
    mode = resolve_mode(args.mode, scene, cfg)
    if mode in ("fused", "wavefront"):
        return mode, render_frame_async(scene, cam, cfg, mode=mode,
                                        spp_batch=args.spp_batch,
                                        budget=budget)
    if mode == "queue":
        return mode, PendingFrame(render_frame_queue(scene, cam, cfg))
    return mode, PendingFrame(*render_frame(scene, cam, cfg, with_count=True))


def finish_frame(pending, timer: StageTimer, args, stage, lead: bool):
    """Wait for a frame, print its line, encode it on the lead rank and
    run `stage` (the upscale stage or None) on it: the only place the
    frame loop does any of these."""
    idx, png, frame, t0, label = pending
    with timer.stage("wait", frame=idx):
        img, nrays = finish(frame)
    timer.log("render", t0, frame=idx)   # issue -> on the host
    dt = (timer.now() - t0) * 1e-9
    rays = ("" if nrays is None else
            f", {mrays_per_sec(nrays, dt):.1f} Mrays/s, {nrays} rays exact")
    print(f"  [frame {idx}] render ({label}) + wait: {dt*1e3:.0f} ms{rays}")
    if lead:
        with timer.stage("encode", frame=idx):
            encode(png, img, timer, args)
    if stage is not None:
        stage(png, img, idx, timer)


def encode(png: str, img, timer: StageTimer, args) -> None:
    """Write a frame's PNG (and PPM); the caller holds its `encode`
    span."""
    image_io.write_png(png, img)
    if args.save_ppm:
        image_io.write_ppm(png[:-4] + ".ppm", img)
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


def render_config(args) -> RenderConfig:
    """The frames' RenderConfig from the parsed flags."""
    return RenderConfig(width=args.width, height=args.height, spp=args.spp,
                        max_depth=args.max_depth, vfov=args.vfov,
                        gamma=args.gamma, seed=args.seed, sky_type=args.sky)


def frame_inputs(args, scene, frame, device):
    """(scene, camera) of one pose's frame as the frame loop renders it:
    `scene` lit by the frame's sun, and the camera at the frame's
    model-space position looking at the origin with the flags' field of
    view and size."""
    cam = point_camera_at(frame.cam_in_model, (0.0, 0.0, 0.0),
                          vfov=args.vfov, width=args.width,
                          height=args.height, device=device)
    return scene.with_sun(frame.sun_dir_model), cam


def run(args, scene=None) -> int:
    """Render every pose of the pose file; `scene` (compiled on the
    device of --device) replaces the scene the mesh flags describe.
    With --shard the process is a rank of torch.distributed.run's group:
    every rank builds the scene and renders its share of each frame, and
    rank 0 alone prints to stdout and writes files."""
    device = resolve_device(args.device)
    if not args.shard:
        return _run(args, scene, device, None)
    from dsrt_tpu_torch.parallel.mesh import leave, make_mesh
    try:
        mesh = make_mesh(sp=args.shard_sp, device=device)
        if mesh.rank == 0:
            return _run(args, scene, mesh.device, mesh)
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _run(args, scene, mesh.device, mesh)
    finally:
        leave()


def _run(args, scene, device, mesh) -> int:
    lead = mesh is None or mesh.rank == 0
    timer = StageTimer()
    with timing.recording(timer), timer.stage("run"):
        _render_poses(args, scene, device, mesh, lead, timer)
    if args.timings_tsv and lead:
        timer.write_tsv(args.timings_tsv)

    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()   # every rank is done with the card
    if not args.upscale:
        print("Upscaling disabled (use --upscale to enable).")
    return 0


def _render_poses(args, scene, device, mesh, lead: bool,
                  timer: StageTimer) -> None:
    """The frame loop of _run: render every selected pose and, on the
    lead rank, encode it and run the upscale stage; each stage is a span
    of `timer`."""
    if lead:
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

    stage = UpscaleStage(args, device) if args.upscale and lead else None
    cfg = render_config(args)
    budget = (FUSED_DISPATCH_RAYS if args.dispatch_rays is None
              else args.dispatch_rays)
    total_start = time.perf_counter()
    rendered = 0
    pending = None   # the issued frame not yet finished (pipeline)
    prof = None
    profiled = not (args.profile and lead)
    for i, pose in enumerate(poses):
        if args.hosts > 1 and i % args.hosts != args.host_id:
            continue   # another host renders this frame
        if i < args.start_frame:
            continue
        png = os.path.join(args.output_dir, f"frame_{i:04d}.png")
        if args.resume and os.path.exists(
                png if stage is None else stage.final(png)):
            continue
        frame = pose_to_frame(pose)
        if frame is None:
            print(f"[{i}] camera inside/too close to model; skipping frame.")
            continue
        print(f"\n=== Frame {i} ===")
        print(f"  sep(cam, model) = {frame.separation_m:.3f} m")
        print(f"  sun_dir_model   = ({frame.sun_dir_model[0]:.6f}, "
              f"{frame.sun_dir_model[1]:.6f}, {frame.sun_dir_model[2]:.6f})")
        with timer.stage("inputs", frame=i):
            frame_scene, cam = frame_inputs(args, scene, frame, device)
        if not profiled:
            prof, profiled = start_profile(device), True
        t0 = timer.now()
        with timer.stage("issue", frame=i):
            label, issued = issue_frame(args, i, frame_scene, cam, cfg,
                                        mesh, budget)
        rendered += 1
        if prof is not None:
            if issued.done is not None:
                issued.done.synchronize()
            stop_profile(prof, args.profile)
            prof = None
        # finish the frame before while this one renders
        if pending is not None:
            finish_frame(pending, timer, args, stage, lead)
        pending = (i, png, issued, t0, f"{label} on {device.type}")
        if args.no_pipeline or issued.done is None:
            finish_frame(pending, timer, args, stage, lead)
            pending = None
    if pending is not None:
        finish_frame(pending, timer, args, stage, lead)
    if stage is not None:
        stage.close(timer)

    total = time.perf_counter() - total_start
    print(f"\nTotal runtime: {total:.3f} s ({rendered} frames)")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not 0 <= args.host_id < args.hosts:
        parser.error(f"--host_id {args.host_id} outside [0, --hosts "
                     f"{args.hosts})")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
