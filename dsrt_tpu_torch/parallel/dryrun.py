"""Multi-rank dry run and a rank-side frame runner (port of
__graft_entry__.py:29-160, `_dryrun_impl` and `dryrun_multichip`).

`dryrun_multichip(n_ranks, device)` spawns n ranks on this machine and
makes JAX's three checks on the detail-1 stand-in at 48x24:
- the sp = 2 sharded render (sp = 2 when n is even, else 1) equals
  `render_frame_sp_emulated` bit for bit;
- the dp-only sharded render equals `render_frame`;
- `render_frame_fused_sharded` at spp 1 equals `render_frame_fused`
  (k = 2 packets, so with more ranks than 2 some shards are all padding).
A failed check raises on rank 0, which fails the run.  The ranks join
over gloo on the CPU, or on cuda ranks by mesh.py's rule; the ranks
render on the card unless the caller asks for the CPU, and without a card
the run raises before any rank starts.

`render_jobs` is a rank function for a list of `Job`s (the CPU tests
and the card's smoke test): every rank builds each job's scene and
camera, renders the sharded frame, and rank 0 saves the images, the ray
counts and each rank's pixels and launches with torch.save.

    python -m dsrt_tpu_torch.parallel.dryrun --ranks 2
    python -m dsrt_tpu_torch.parallel.dryrun --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from dsrt_tpu_torch.config import RenderConfig
from dsrt_tpu_torch.device import resolve_device
from dsrt_tpu_torch.parallel.mesh import auto_mesh, make_mesh, spawn_ranks
from dsrt_tpu_torch.parallel.render import (render_frame_fused_sharded,
                                            render_frame_sharded,
                                            render_frame_sp_emulated,
                                            rank_shard)


def _dryrun_rank(device: str) -> None:
    from dsrt_tpu_torch.models.mesh_gen import iss_standin_scene
    from dsrt_tpu_torch.ops.camera import point_camera_at
    from dsrt_tpu_torch.render import render_frame, render_frame_fused

    mesh = auto_mesh(device=device)
    n, sp = mesh.sp * mesh.dp, mesh.sp
    dev = mesh.device
    cfg = RenderConfig(width=48, height=24, spp=2 * sp, max_depth=4)
    scene = iss_standin_scene(detail=1, device=dev)
    # close enough that the stand-in covers pixels, so lit > 0 shows
    # that shading ran
    cam = point_camera_at((20.0, 30.0, 95.0), (0.0, 0.0, 0.0),
                          vfov=cfg.vfov, width=cfg.width, height=cfg.height,
                          device=dev)
    lead = mesh.rank == 0

    def require(cond: bool, what: str) -> None:
        if not cond:
            raise RuntimeError(f"dryrun_multichip: {what}")

    img = render_frame_sharded(scene, cam, cfg, mesh)
    if lead:
        require(img.shape == (cfg.height, cfg.width, 3)
                and img.dtype == np.uint8, f"image {img.shape} {img.dtype}")
        lit = float((img > 0).mean())
        require(lit > 0.0, "the sharded render is all black")
        if sp == 2:
            require(np.array_equal(
                img, render_frame_sp_emulated(scene, cam, cfg, sp=2)),
                "sp=2 sharded render != the slice-schedule emulation")
    mesh_dp = make_mesh(n, sp=1, device=device)
    img_dp = render_frame_sharded(scene, cam, cfg, mesh_dp)
    if lead:
        require(np.array_equal(img_dp, render_frame(scene, cam, cfg)),
                "dp-sharded render != render_frame")
    fcfg = RenderConfig(width=48, height=24, spp=1, max_depth=3)
    img_f = render_frame_fused_sharded(scene, cam, fcfg, mesh_dp)
    if lead:
        require(np.array_equal(img_f, render_frame_fused(scene, cam, fcfg)),
                "dp-sharded megakernel frame != render_frame_fused")
        print(f"dryrun_multichip ok: {n} ranks on {dev}, backend "
              f"{mesh.backend}, mesh={mesh.shape} img={img.shape} "
              f"lit_frac={lit:.4f} dp_equal=True "
              f"sp_deterministic_equal={sp == 2} fused_dp{n}_equal=True",
              flush=True)


def dryrun_multichip(n_ranks: int, device=None) -> None:
    """Spawn `n_ranks` ranks rendering on `device` (None: the card) and
    make the three checks of the module docstring; raises when one fails,
    and before spawning when CUDA is asked for and there is no card."""
    dev = resolve_device(device)
    spawn_ranks(_dryrun_rank, n_ranks, dev.type,
                threads=1 if dev.type == "cpu" else None)


@dataclasses.dataclass(frozen=True)
class Job:
    """One sharded frame of `render_jobs`.  `scene` and `camera` are
    called with device=, on every rank (functools.partial of importable
    builders, so that spawn can pickle them); `fused` takes
    render_frame_fused_sharded (dp only), else render_frame_sharded on
    an (sp, world / sp) mesh."""
    name: str
    scene: Callable
    camera: Callable
    cfg: RenderConfig
    sp: int = 1
    fused: bool = False


def job_inputs(job: Job, device, scenes: dict):
    """(mesh, scene, camera) of a job on this rank; `scenes` keeps the
    scenes built so far, by their builder."""
    mesh = make_mesh(sp=job.sp, device=device)
    key = repr(job.scene)
    if key not in scenes:
        scenes[key] = job.scene(device=mesh.device)
    return mesh, scenes[key], job.camera(device=mesh.device)


def _launch_counts() -> dict:
    """The kernels' launch counts so far, the traversal kernel's by
    query."""
    from dsrt_tpu_torch.ops import path_kernel, sphere_kernel, traverse
    counts = dict(path_kernel.LAUNCHES, **sphere_kernel.LAUNCHES)
    for name, query in (("dsrt_traverse", "closest"),
                        ("dsrt_traverse any-hit", "any"),
                        ("dsrt_traverse_sun", "sun")):
        counts[name] = sum(traverse.INSTANCE_LAUNCHES[(query, w)]
                           for w in traverse.WALKS)
    return counts


def render_jobs(jobs, out: str, device=None) -> None:
    """Rank function: render each Job across every rank on `device` (None:
    the rank's card); rank 0 saves
    {job name: {"img": u8 numpy, "rays": exact count (fused) or None,
    "ranks": [each rank's dict]}} to `out`.  A rank's dict holds its
    place in the mesh, its pixels and the kernels it launched in the
    frame."""
    results, scenes = {}, {}
    for job in jobs:
        mesh, scene, cam = job_inputs(job, device, scenes)
        before = _launch_counts()
        if job.fused:
            img, rays = render_frame_fused_sharded(scene, cam, job.cfg, mesh,
                                                   with_count=True)
        else:
            img, rays = render_frame_sharded(scene, cam, job.cfg, mesh), None
        after = _launch_counts()
        _, live, _ = rank_shard(job.cfg, mesh)
        mine = dict(rank=mesh.rank, sp_index=mesh.sp_index,
                    dp_index=mesh.dp_index, pixels=int(live.sum()),
                    launches={k: after[k] - before[k] for k in after})
        every = [None] * dist.get_world_size() if mesh.rank == 0 else None
        dist.gather_object(mine, every, dst=0)
        if mesh.rank == 0:
            results[job.name] = dict(img=img, rays=rays, ranks=every)
    if dist.get_rank() == 0:
        torch.save(results, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dsrt_tpu_torch.parallel.dryrun",
        description="multi-rank dry run of the sharded renders")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cuda (the default: each rank on cuda:{rank % "
                        "cards}; NCCL when every rank has its own card) or "
                        "cpu (gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
