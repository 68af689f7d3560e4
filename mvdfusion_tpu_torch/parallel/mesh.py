"""Data parallelism over torch.distributed (counterpart of
mvdfusion_tpu/parallel/mesh.py's `dp` axis).

The JAX package runs one SPMD program over a device mesh: scenes shard over
`dp` and XLA inserts the gradient all-reduce. Here each rank is a process
with one device, as in the reference's DDP (train.py:32-38): scenes split
over ranks by position, the trainer averages its accumulated gradient over
them once per optimizer step (`all_reduce_mean_`), and rank 0 alone writes
files. Ranks start from torchrun's environment (`init_distributed`) or from
`spawn` on one host. The tensor- and view-parallel axes (`tp`, `sp`) are not
ported: `make_mesh` raises on them.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

_TP_SP = "(ROADMAP Queue 1: tensor and view parallelism)"
BUCKET_BYTES = 64 << 20  # the all-reduce's and the broadcast's bucket size


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    sp: int
    rank: int
    world: int
    device: torch.device


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: start the ranks with torchrun (or parallel.spawn)")
    return int(os.environ[name])


def init_distributed(device_type: str = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
    return this rank's device: cuda:{LOCAL_RANK} (modulo the visible cards)
    or the CPU. The backend is NCCL where every local rank has a card of its
    own, else gloo (the CPU, or more local ranks than cards: NCCL refuses
    two ranks on one device). On the CPU the local ranks share the intra-op
    threads out."""
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank, local_world = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
    _env_int("MASTER_PORT")
    if "MASTER_ADDR" not in os.environ:
        raise RuntimeError("MASTER_ADDR is not set: start the ranks with torchrun (or parallel.spawn)")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= cards else "gloo"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(max(1, torch.get_num_threads() // local_world))  # the host's cores shared out
    else:
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, device=None, world: Optional[int] = None) -> Mesh:
    """The (dp, tp, sp) layout over `world` ranks (default: the process
    group's size, 1 without one): dp defaults to world // (tp * sp) and
    dp * tp * sp may not exceed world, as in the JAX make_mesh."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if tp > 1 or sp > 1:
        raise NotImplementedError(f"tp = {tp}, sp = {sp}: tensor and view parallelism are not ported {_TP_SP}")
    if dp is None:
        dp = world // (tp * sp)
    if dp * tp * sp > world:
        raise ValueError(f"mesh {dp}x{sp}x{tp} needs more than the {world} available ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(dp=dp, tp=tp, sp=sp, rank=rank, world=world, device=torch.device(device or "cpu"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, fn, nprocs: int, port: int, args: tuple) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = ()) -> None:
    """Run fn(*args) in `nprocs` local ranks with torchrun's environment set
    (MASTER_ADDR 127.0.0.1, a free port); `fn` calls init_distributed. Joins
    them all; raises (ProcessRaisedException, ProcessExitedException) if any
    fails."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(fn, nprocs, free_port(), args), nprocs=nprocs, join=True,
                       start_method="spawn")


def is_main() -> bool:
    """Rank 0, or the one process without a process group: the one that
    writes files and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _buckets(tensors):
    """Consecutive runs of one dtype and device of at most BUCKET_BYTES (a
    larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device or size + t.nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.nbytes
    if run:
        yield run


@torch.no_grad()
def _bucketed_(tensors, op) -> None:
    for run in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        torch._foreach_copy_(run, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in run]), run)])


def all_reduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the ranks, in place: the tensors
    flattened into buckets of one dtype (at most BUCKET_BYTES), one
    all_reduce(SUM) a bucket, then a division by the world size. Every rank
    must pass the same tensors in the same order, or the collective hangs.
    Without a process group it does nothing."""
    if not dist.is_initialized():
        return
    n = dist.get_world_size()

    def op(flat):
        dist.all_reduce(flat)
        flat.div_(n)

    _bucketed_(tensors, op)


def broadcast_(tensors, src: int = 0) -> None:
    """Copy rank `src`'s values into every rank's tensors, in place, in
    buckets as all_reduce_mean_. Without a process group it does nothing."""
    if dist.is_initialized():
        _bucketed_(tensors, lambda flat: dist.broadcast(flat, src))


def gather_objects(obj) -> list:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def local_first(fn):
    """fn() on each host's local rank 0 while that host's other ranks wait at
    a barrier, then on them (a build that one process per host should make,
    as the kernels' nvcc fan-out)."""
    if not dist.is_initialized():
        return fn()
    first = int(os.environ.get("LOCAL_RANK", "0")) == 0
    out = fn() if first else None
    dist.barrier()
    return out if first else fn()
