"""Megatron-style tensor parallelism's collectives (the port's counterpart of
the all-gathers and all-reduces XLA inserts for mvdfusion_tpu/parallel/
mesh.py's `tp` and `sp` axes).

A parameter that the layout splits carries its `Split` (`split_of`): the
torch dim it is cut along, the number of packed blocks along that dim that
are each cut alike (GEGLU's value and gate halves, CLIP's packed q | k | v),
and the mesh axis it is cut over. The layers read it and run on their
shard: a column layer (weight cut along its outputs) on `copy_to` of its
input, a row layer (cut along its inputs) on its input's own slice, its fp32
partial products summed by `reduce_from`. Each collective is an autograd
Function whose backward is its conjugate:

  copy_to       identity        | all-reduce of the gradient
  reduce_from   all-reduce      | identity
  gather_from   all-gather      | the gradient's own slice
  scatter_to    own slice       | all-gather of the gradient
  gather_rows   the sp axis's all-gather along dim 0, uneven slices allowed;
                backward: the all-reduced gradient's own rows

An all-gather is the collective itself: NCCL takes it, and gloo takes it
on CPU tensors and, though torch's backend table lists only broadcast and
all_reduce for gloo on the GPU, on CUDA tensors too (torch 2.11 on an H100:
chip_smoke.py's tp phase asks it, and fails if it is refused). The sp
axis' uneven gather is an all_reduce of a zero buffer in which each rank
wrote its rows: exact (x + 0 = x). Sums (`reduce_from`, `copy_to`'s
backward) run in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: its process group (None where the
    axis has one rank), its size, this rank's coordinate on it and the
    global ranks along it in coordinate order."""

    group: object
    size: int
    rank: int
    ranks: tuple

    @property
    def src(self) -> int:
        """The global rank at coordinate 0 (a broadcast's source)."""
        return self.ranks[0]


ONE = Axis(group=None, size=1, rank=0, ranks=(0,))


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """How a parameter is cut: along torch dim `dim`, `parts` packed blocks
    each cut into axis.size slices, this rank holding slice axis.rank of
    each block."""

    dim: int
    parts: int
    axis: Axis


def split_of(p) -> Optional[Split]:
    return getattr(p, "_mvdf_split", None)


def shard(full: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's slice of a whole tensor (contiguous)."""
    n, a = split.axis.size, split.axis.rank
    blocks = full.chunk(split.parts, dim=split.dim)
    return torch.cat([b.chunk(n, dim=split.dim)[a] for b in blocks], dim=split.dim).contiguous()


def unshard(pieces: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's slice (in coordinate order)."""
    per = [p.chunk(split.parts, dim=split.dim) for p in pieces]
    return torch.cat([per[r][j] for j in range(split.parts) for r in range(len(pieces))], dim=split.dim)


def all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's `t` (one shape on every rank) in coordinate order."""
    t = t.contiguous()
    if axis.size == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(out, t, group=axis.group)
    return out


def all_reduce_fp32(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of `t` over the axis, summed in fp32, in t's dtype."""
    if axis.size == 1:
        return t
    s = t.float().contiguous().clone() if t.dtype != torch.float32 else t.contiguous().clone()
    dist.all_reduce(s, group=axis.group)
    return s.to(t.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_fp32(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_fp32(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, parts):
        ctx.split = Split(dim, parts, axis)
        return unshard(all_gather(x, axis), ctx.split)

    @staticmethod
    def backward(ctx, g):
        return shard(g, ctx.split), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, parts):
        ctx.split = Split(dim, parts, axis)
        return shard(x, ctx.split)

    @staticmethod
    def backward(ctx, g):
        return unshard(all_gather(g, ctx.split.axis), ctx.split), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, sizes):
        ctx.axis, ctx.sizes = axis, sizes
        off = sum(sizes[: axis.rank])
        buf = torch.zeros((sum(sizes), *x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[off : off + x.shape[0]] = x
        if axis.size > 1:
            dist.all_reduce(buf, group=axis.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        off = sum(ctx.sizes[: ctx.axis.rank])
        return all_reduce_fp32(g, ctx.axis)[off : off + ctx.sizes[ctx.axis.rank]], None, None


def copy_to(x, axis: Axis):
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x, axis: Axis):
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x, axis: Axis, dim: int = -1, parts: int = 1):
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim % x.ndim, parts)


def scatter_to(x, axis: Axis, dim: int = -1, parts: int = 1):
    return x if axis.size == 1 else _ScatterTo.apply(x, axis, dim % x.ndim, parts)


def gather_rows(x, axis: Axis, sizes: Sequence[int]):
    """The sp axis' all-gather along dim 0: rank a holds sizes[a] rows (uneven
    where the views do not divide), made with an all-reduce of a zero
    buffer."""
    return x if axis.size == 1 else _GatherRows.apply(x, axis, tuple(sizes))


def even_slices(n: int, parts: int) -> list:
    """n items cut into `parts` runs, the first n % parts one longer
    (np.array_split's cut), as slices."""
    q, r = divmod(n, parts)
    bounds = [0]
    for a in range(parts):
        bounds.append(bounds[-1] + q + (a < r))
    return [slice(bounds[a], bounds[a + 1]) for a in range(parts)]


def full_param(p: torch.Tensor) -> torch.Tensor:
    """The whole parameter: `p` where it is not split, else its slices
    gathered over the axis (the gradient reaches the shard as its own
    slice)."""
    s = split_of(p)
    return p if s is None else gather_from(p, s.axis, s.dim, s.parts)


def whole(p: torch.Tensor) -> torch.Tensor:
    """full_param, kept on the parameter until its data or version changes
    where no gradient reaches it (a kernel that packs its weight once keeps
    the packing on this tensor)."""
    s = split_of(p)
    if s is None:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return full_param(p)
    key = (p.data_ptr(), p._version)
    hit = getattr(p, "_mvdf_whole", None)
    if hit is None or hit[0] != key:
        hit = (key, unshard(all_gather(p.detach(), s.axis), s))
        p._mvdf_whole = hit
    return hit[1]


def local_bias(b: Optional[torch.Tensor], w: torch.Tensor) -> Optional[torch.Tensor]:
    """The bias slice of a layer whose weight `w` is split along its outputs
    (the bias stays whole, as in the JAX rule)."""
    s = split_of(w)
    if b is None or s is None or s.dim != 0:
        return b
    return scatter_to(b, s.axis, 0, s.parts)
