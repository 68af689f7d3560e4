"""The (dp, sp, tp) mesh over torch.distributed (counterpart of
mvdfusion_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh and lets XLA insert
the collectives. Here each rank is a process with one device, as in the
reference's DDP (train.py:32-38), and the collectives are explicit:

  * dp: scenes split over ranks by position; the trainer averages its
    accumulated gradient once per optimizer step over dp x sp
    (`all_reduce_mean_` on `Mesh.axes["grad"]`), and rank 0 alone writes
    files.
  * sp: a scene's target views split over ranks; each runs the UNet on its
    views, GridAttn queries only its views but reads every view's latent
    (nn/viewfusion.py, nn/viewattn.py).
  * tp: Megatron column/row splits of the UNet's, CLIP's and the VAE's
    weights (`param_spec`, the JAX `_spec_for` on the port's names), run by
    the layers through parallel/tensor.py's collectives.

Ranks are laid out as in the JAX make_mesh's device grid: tp fastest, then
sp, then dp (rank = (d * sp + s) * tp + t). Ranks start from torchrun's
environment (`init_distributed`) or from `spawn` on one host.
"""

from __future__ import annotations

import dataclasses
import os
import re
import socket
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from mvdfusion_tpu_torch.parallel.tensor import ONE, Axis, Split, all_gather, shard, split_of, unshard

BUCKET_BYTES = 64 << 20  # the all-reduce's and the broadcast's bucket size


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The layout and this rank's place in it: `coords` (d, s, t), None for
    a rank past the layout; `axes` "dp", "sp", "tp" and "grad" (dp x sp, over
    which gradients are averaged), each an Axis with its process group."""

    dp: int
    tp: int
    sp: int
    rank: int
    world: int
    device: torch.device
    coords: Optional[tuple]
    axes: dict


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


def mesh_coords(rank: int, dp: int, sp: int, tp: int) -> Optional[tuple]:
    """(d, s, t) of `rank` in the (dp, sp, tp) grid, tp fastest (the JAX
    make_mesh's reshape(dp, sp, tp) of the device list), or None past it."""
    if rank >= dp * sp * tp:
        return None
    return rank // (sp * tp), (rank // tp) % sp, rank % tp


def _axis_ranks(dp: int, sp: int, tp: int) -> dict:
    """Every group of each axis as its global ranks in coordinate order."""
    at = lambda d, s, t: (d * sp + s) * tp + t
    return dict(
        tp=[[at(d, s, t) for t in range(tp)] for d in range(dp) for s in range(sp)],
        sp=[[at(d, s, t) for s in range(sp)] for d in range(dp) for t in range(tp)],
        dp=[[at(d, s, t) for d in range(dp)] for s in range(sp) for t in range(tp)],
        grad=[[at(d, s, t) for d in range(dp) for s in range(sp)] for t in range(tp)],
    )


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, device=None, world: Optional[int] = None) -> Mesh:
    """The (dp, sp, tp) layout over `world` ranks (default: the process
    group's size, 1 without one): dp defaults to world // (tp * sp) and
    dp * tp * sp may not exceed world, as in the JAX make_mesh. Under a
    process group every rank must call it alike: it makes one group a
    tp, sp, dp and dp x sp slice of more than one rank (the whole world's
    group where a slice is the world)."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = world // (tp * sp)
    if dp < 1 or dp * tp * sp > world:
        raise ValueError(f"mesh {dp}x{sp}x{tp} needs more than the {world} available ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = mesh_coords(rank, dp, sp, tp)
    axes = dict(dp=ONE, sp=ONE, tp=ONE, grad=ONE)
    if dist.is_initialized():
        whole = list(range(dist.get_world_size()))
        for name, groups in _axis_ranks(dp, sp, tp).items():
            for ranks in groups:
                if len(ranks) == 1:
                    continue
                # every rank creates every group, in one order (new_group's contract)
                group = None if ranks == whole else dist.new_group(ranks)
                if rank in ranks:
                    axes[name] = Axis(group=group, size=len(ranks), rank=ranks.index(rank), ranks=tuple(ranks))
    return Mesh(dp=dp, tp=tp, sp=sp, rank=rank, world=world, device=torch.device(device or "cpu"), coords=coords,
                axes=axes)


# ---------------------------------------------------------------- tp layout
class Spec(NamedTuple):
    """A parameter's tp cut: torch dim `dim`, `parts` packed blocks."""

    dim: int
    parts: int


# The JAX package's Megatron rules (mesh.py:65-123) on the port's names.
# Column layers (split outputs, torch dim 0): attention q/k/v, CLIP's packed
# in_proj and c_fc, the GEGLU projection, the ResBlocks' emb_layers and the
# time-embed MLPs' first layer. Row layers (split inputs, torch dim 1; CLIP's
# visual.proj, kept (in, out) as in flax, dim 0): attention to_out, CLIP's
# out_proj and c_proj, the FeedForward's net.2, the time MLPs' second layer.
_COLUMN = re.compile(r"(\.to_[qkv]\.weight|\.attn\.in_proj_weight|\.c_fc\.weight|\.ff\.net\.0\.proj\.weight"
                     r"|\.emb_layers\.1\.weight|(^|\.)time_embed\.0\.weight)$")
_ROW = re.compile(r"(\.to_out\.0\.weight|\.out_proj\.weight|\.c_proj\.weight|\.ff\.net\.2\.weight"
                  r"|(^|\.)time_embed\.2\.weight)$")
_CLIP_PROJ = "clip_image_encoder.model.visual.proj"
# The transformer sites' kernels read their weights whole, so those stay
# whole: the JAX rule's _FUSED_SITE (SpatialTransformer sites, any 2-D
# weight whose smaller dim is at most 768, which also keeps the C=1280
# sites' 768 -> 1280 attn2.to_k/to_v whole), and the grafted ViewAligned
# sites that take a site kernel (C <= 768), which _FUSED_SITE misses.
_SPATIAL_SITE = re.compile(r"unet_model\.unet_model\.(input_blocks\.\d+\.1|middle_block\.1|output_blocks\.\d+\.1)\.")
_VIEW_SITE = re.compile(r"\.aligned_attn_transformer_blocks\.")
_FUSED_MIN_DIM = 768


def _packed(name: str) -> int:
    if name.endswith("attn.in_proj_weight"):
        return 3  # q | k | v
    if name.endswith("ff.net.0.proj.weight"):
        return 2  # GEGLU's value | gate
    return 1


def param_spec(name: str, shape, tp: int) -> Optional[Spec]:
    """The tp cut of parameter `name` (the port's state-dict name) of whole
    torch shape `shape`, or None (whole on every rank): the JAX _spec_for on
    the mapped flax path, in torch's layout. Gates use the real tp."""
    shape = tuple(shape)
    if tp == 1 or name.startswith("view_attn."):  # GridAttn rides whole into K4
        return None
    if len(shape) == 4 and shape[2:] == (1, 1):
        shape = shape[:2]  # a 1x1 conv is a flax Dense
    if len(shape) == 2:
        if name == _CLIP_PROJ:
            return Spec(0, 1) if shape[0] % tp == 0 else None
        if _SPATIAL_SITE.search(name) and min(shape) <= _FUSED_MIN_DIM:
            return None
        if _VIEW_SITE.search(name):
            width = shape[1] if name.endswith("ff.net.0.proj.weight") else shape[0]
            if width <= _FUSED_MIN_DIM:
                return None
        if _COLUMN.search(name):
            parts = _packed(name)
            return Spec(0, parts) if (shape[0] // parts) % tp == 0 else None
        if _ROW.search(name):
            return Spec(1, 1) if shape[1] % tp == 0 else None
        return None
    if len(shape) == 4 and shape[0] % tp == 0 and shape[0] >= 4 * tp:  # conv: output features
        return Spec(0, 1)
    return None


def full_shape(p) -> tuple:
    """A parameter's whole shape (its shard's, scaled along the split dim)."""
    s, shape = split_of(p), list(p.shape)
    if s is not None:
        shape[s.dim] *= s.axis.size
    return tuple(shape)


def param_layout(model, tp: int) -> dict:
    """name -> Spec or None for every parameter (the counterpart of
    param_shardings)."""
    return {n: param_spec(n, full_shape(p), tp) for n, p in model.named_parameters()}


@torch.no_grad()
def shard_params_(model, mesh: Mesh):
    """Keep this rank's slice of every parameter the layout splits over the
    mesh's tp axis, in place (each split parameter carries its Split), and
    set `model.mesh`. The model must hold whole parameters (a loader writes
    whole tensors first). Returns the model."""
    if any(split_of(p) is not None for p in model.parameters()):
        raise ValueError("shard_params_: the model is already split")
    axis = mesh.axes["tp"]
    for name, spec in param_layout(model, mesh.tp).items():
        if spec is None:
            continue
        p = model.get_parameter(name)
        if p.shape[spec.dim] % (spec.parts * mesh.tp):
            raise ValueError(f"{name}: {tuple(p.shape)} does not split {mesh.tp} ways along dim {spec.dim}")
        split = Split(spec.dim, spec.parts, axis)
        p.data = shard(p.data, split)
        p._mvdf_split = split
    model.mesh = mesh
    return model


def gather_tensor(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """The whole tensor from this rank's slice `t` (a collective over the
    split's axis; `t` itself where split is None)."""
    t = t.detach()
    return t if split is None else unshard(all_gather(t, split.axis), split)


@torch.no_grad()
def gather_params(model, mesh: Optional[Mesh] = None) -> dict:
    """name -> the whole parameter (detached), on every rank of the tp group
    (rank 0 among them): the split ones gathered over tp, a collective every
    rank of the group calls."""
    return {n: gather_tensor(p, split_of(p)) for n, p in model.named_parameters()}


def shard_like(full: torch.Tensor, p) -> torch.Tensor:
    """This rank's slice of a whole tensor for parameter `p` (the tensor
    itself where `p` is whole)."""
    s = split_of(p)
    return full if s is None else shard(full, s)


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


def all_reduce_mean_(tensors, axis: Optional[Axis] = None) -> None:
    """Replace each tensor by its mean over the ranks of `axis` (default:
    every rank), in place: the tensors flattened into buckets of one dtype
    (at most BUCKET_BYTES), one all_reduce(SUM) a bucket, then a division
    by the ranks' count. Every rank must pass the same tensors in the same
    order, or the collective hangs. Without a process group, or on an axis
    of one rank, it does nothing."""
    if not dist.is_initialized() or (axis is not None and axis.size == 1):
        return
    group, n = (None, dist.get_world_size()) if axis is None else (axis.group, axis.size)

    def op(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _bucketed_(tensors, op)


def broadcast_(tensors, src: int = 0, axis: Optional[Axis] = None) -> None:
    """Copy global rank `src`'s values into the tensors of every rank (of
    `axis`, default every rank), in place, in buckets as all_reduce_mean_.
    Without a process group it does nothing."""
    if dist.is_initialized() and (axis is None or axis.size > 1):
        group = None if axis is None else axis.group
        _bucketed_(tensors, lambda flat: dist.broadcast(flat, src, group=group))


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
