"""Rank mesh for multi-GPU rendering (port of dsrt_tpu/parallel/mesh.py:
1-42).

The renderer's two parallel axes:
- `dp`: pixel parallelism; each rank renders a block of the frame's
  1024-lane packets, and rank 0 gathers the blocks;
- `sp`: sample parallelism; spp is split across ranks and their sums
  are all-reduced.

Ranks take the place of JAX's devices: rank r sits at (sp = r // dp,
dp = r % dp), as JAX's `reshape(sp, dp)` of the device list places
device r.  A rank renders on its own device, cuda:{LOCAL_RANK % device
count}, or on the CPU when the caller asks for it.

`join` puts the process into a process group from the environment that
torch.distributed.run sets (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with no such environment
the process is a group of one.  The collective backend follows one rule,
printed by rank 0, never switched when it fails:
- NCCL when every rank of the machine owns its own card (LOCAL_WORLD_SIZE
  at most the device count);
- gloo when ranks share a card (NCCL refuses two ranks on one GPU) or
  render on the CPU.  gloo's collectives run on host tensors.
The kernel library and the native BVH builder are loaded by rank 0
first and by the other ranks after a barrier, so a cold start compiles
each once.  `spawn_ranks` runs a function on n ranks of this machine
(torch.multiprocessing, start method spawn), re-raises a rank's error
and ends ranks that outlive a time limit.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from dsrt_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in an (sp, dp) mesh of every rank."""
    sp: int
    dp: int
    rank: int
    device: torch.device       # where this rank renders
    backend: str
    device_mesh: object        # torch DeviceMesh, dims ("sp", "dp")

    @property
    def shape(self) -> dict:
        return {"sp": self.sp, "dp": self.dp}

    @property
    def sp_index(self) -> int:
        return self.rank // self.dp

    @property
    def dp_index(self) -> int:
        return self.rank % self.dp

    @property
    def comm_device(self) -> torch.device:
        """Where this rank's collectives run: its card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def group(self, dim: str):
        """The process group of this rank's row along `dim` ("sp": the
        ranks of its dp shard; "dp": the ranks of its sp slice)."""
        return self.device_mesh.get_group(dim)


def mesh_shape(n: int, sp: int) -> tuple[int, int]:
    """(sp, dp) of a mesh over n ranks; sp must divide n."""
    if sp < 1 or n % sp != 0:
        raise ValueError(f"sp={sp} must divide the rank count {n}")
    return sp, n // sp


def auto_sp(n: int) -> int:
    """JAX's default topology: sp = 2 when the count is even and above 1
    (halves each rank's samples), else pure dp."""
    return 2 if (n > 1 and n % 2 == 0) else 1


def rank_device(device, local_rank: int) -> torch.device:
    """The device rank `local_rank` of this machine renders on: `device`
    (None: CUDA) with a CUDA device's index taken as local_rank modulo
    the card count.  Raises when CUDA is asked for and there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def backend_for(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why) by the rule of the module docstring."""
    if device.type != "cuda":
        return "gloo", f"ranks render on {device.type}"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} ranks here, {cards} cards: a card each"
    return "gloo", (f"{local_world} ranks share {cards} card(s); NCCL takes "
                    "one rank a card")


def _world() -> tuple[int, int, int, int]:
    """(rank, world, local rank, local world) from the environment."""
    env = os.environ
    rank = int(env.get("RANK", 0))
    world = int(env.get("WORLD_SIZE", 1))
    return (rank, world, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world)))


def _load_builds(device: torch.device) -> None:
    from dsrt_tpu_torch import native
    native.available()
    if device.type == "cuda":
        from dsrt_tpu_torch.ops import build
        build.load()


def join(device=None) -> tuple[int, int, torch.device, str]:
    """Join the process group (once a process) and return (rank, world
    size, this rank's device, backend).  A failed start raises."""
    rank, world, local_rank, local_world = _world()
    dev = rank_device(device, local_rank)
    backend, why = backend_for(dev, local_world)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", ranks on {dev} take {backend} ({why})")
        return dist.get_rank(), dist.get_world_size(), dev, backend
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    rank = dist.get_rank()
    if rank == 0:
        print(f"sharding: {world} rank(s), rank 0 on {dev}, backend "
              f"{backend} ({why})", flush=True)
        _load_builds(dev)
    dist.barrier()
    if rank != 0:
        _load_builds(dev)
    return rank, world, dev, backend


def leave() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device=None) -> RankMesh:
    """Mesh with dims ("sp", "dp") over every rank; sp must divide the
    rank count (ValueError).  Ranks take the place of JAX's `devices`:
    `n_devices`, when given, must be the rank count, and `device` is the
    device each rank renders on (None: its card)."""
    world = dist.get_world_size() if dist.is_initialized() else _world()[1]
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices={n}: the mesh spans all {world} ranks")
    sp, dp = mesh_shape(n, sp)
    rank, _, dev, backend = join(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", (sp, dp),
                          mesh_dim_names=("sp", "dp"))
    return RankMesh(sp, dp, rank, dev, backend, dm)


def auto_mesh(n_devices: Optional[int] = None, device=None) -> RankMesh:
    """make_mesh with auto_sp's sp."""
    world = dist.get_world_size() if dist.is_initialized() else _world()[1]
    n = world if n_devices is None else int(n_devices)
    return make_mesh(n, sp=auto_sp(n), device=device)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, n_ranks: int, port: int, threads, fn, args):
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        fn(*args)
    finally:
        leave()


def spawn_ranks(fn, n_ranks: int, *args, threads: Optional[int] = None,
                timeout: Optional[float] = None) -> None:
    """Run fn(*args) on `n_ranks` ranks of this machine, each a process
    started by torch.multiprocessing (start method spawn) with RANK,
    WORLD_SIZE, ... set and `threads` intra-op threads (None: PyTorch's
    default).  `fn` must be importable by name.  Waits for every rank; a
    rank's exception ends the others and is raised here, and ranks still
    running after `timeout` seconds are ended with a TimeoutError."""
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(n_ranks, free_port(), threads, fn, args),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None else 1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{n_ranks} ranks still ran after {timeout} s")
