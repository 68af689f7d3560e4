"""K1 and K7: GroupNorm(32) (+SiLU) over (B, N, C) channels-last activations.

K1 replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (via _gn_fwd_impl),
for slices with HW*C <= 2^20: csrc/groupnorm.cu's gn_cluster_kernel, one
launch, one thread block cluster of k CTAs per sample. Each CTA reads its
rows once as 16-byte vectors and keeps them in shared memory, fp32 channel
sums become group sums, the cluster adds its CTAs' group sums in rank order
through distributed shared memory, and each CTA writes its rows normalised:
variance E[x^2] - E[x]^2 clamped at 0, affine, optional SiLU. Bound by bytes
on the H100 (one read, one write per element). `plan_group_norm` picks k and
the CTA's shape from (B, N, C, dtype), once per shape.

K7 replaces the reference's two-pass tiled form for larger maps (the VAE at
64^2..256^2), _gn_tiled_impl with _gn_stats_kernel and _gn_apply_kernel, on
under MVDF_GN_TILED=1 as in the reference: csrc/groupnorm.cu's stats pass
(per-(batch, channel) fp32 sums over row tiles, written as per-tile partials
and summed in a fixed order by a second small kernel: no float atomics, the
same result on every run) that also folds the (B, G) moments into a
per-(batch, channel) affine (the reference folds them in XLA between its
kernels), then the apply pass (x*a + b, optional SiLU). Two reads and one
write of x; bound by bytes. The stats pass also serves
ops/conv3x3.py::gn_fold_affine.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from mvdfusion_tpu_torch.ops import _lib

_MAX_SLICE_ELEMS = 1 << 20
# the reference's row-tile element budget for its tiled form
# (ops/groupnorm.py:42); with _pick_tile it decides where that form runs, not
# how the CUDA kernels tile
_TILE_ELEMS = 1 << 19
# at most this many row tiles per batch element in the stats pass (the
# partials the second pass sums), each at least _STATS_MIN_ROWS rows
_STATS_MAX_TILES = 64
_STATS_MIN_ROWS = 256

# K1's plan (csrc/groupnorm.cu keeps the same limits): at most this many
# threads a CTA, CTAs a cluster (16 is above the portable 8), bytes of
# dynamic shared memory a CTA (the H100's 227 KB) and row lanes a channel
# vector (a power of two: the lanes add their sums with warp shuffles)
GN_MAX_THREADS = 640
GN_MAX_CLUSTER = 16
GN_SMEM_MAX = 232448
GN_MAX_LANES = 16
# threads a CTA aims at: lean CTAs let the card hold more clusters at once
GN_THREADS = 256
# the cluster sizes the plan weighs: at least 4 CTAs share a sample's
# arithmetic (SiLU's two special-function operations an element bound the
# second pass), at most 16 form a cluster
GN_CLUSTERS = (4, 8, 16)
# the plan's cost model, fitted to chip_smoke.py --k1-sweep on the H100: a
# wave of clusters costs a CTA's fixed steps (load latency, the reductions,
# the cluster barriers) plus its rows' bytes in and out at an SM's share of
# the card's 3.35 TB/s
GN_FIXED_US = 5.0
GN_SM_BYTES_PER_US = 3.35e6 / 132


class GNPlan(NamedTuple):
    """K1's launch for one (B, N, C, dtype): k CTAs a sample, `rows` rows a
    CTA (the last may hold fewer or none), P row lanes a channel vector,
    `threads` a CTA, `smem` bytes of dynamic shared memory, `resident`
    whether a CTA keeps its rows in shared memory between its two passes
    (else it reads them again)."""

    k: int
    rows: int
    P: int
    threads: int
    smem: int
    resident: bool


def _vec(dtype) -> int:
    return 8 if dtype == torch.bfloat16 else 4


def gn_stride(cv: int, P: int) -> int:
    """The row stride of K1's rows in shared memory, in 16-byte vectors: cv
    padded to 8 / min(P, 8) mod 8, so the 8 threads of a quarter warp (P
    rows of 8 / P vectors) hit 8 distinct 16-byte bank groups."""
    s = 8 // min(P, 8)
    return cv + (s - cv) % 8


def _plan_k(N: int, C: int, dtype, groups: int, k: int, threads: int) -> GNPlan:
    _lib.dtype_code(dtype)  # bf16 or fp32
    vec = _vec(dtype)
    if C % vec or C % groups:
        raise ValueError(f"K1 takes C divisible by {vec} and by {groups} groups, not C={C}")
    cv = C // vec
    if cv > GN_MAX_THREADS:
        raise ValueError(f"K1 takes C <= {GN_MAX_THREADS * vec} in {dtype}, not C={C}")
    if not 1 <= k <= GN_MAX_CLUSTER:
        raise ValueError(f"K1's cluster size {k} is outside 1..{GN_MAX_CLUSTER}")
    P = 1
    while 2 * P <= GN_MAX_LANES and cv * 2 * P <= threads:
        P *= 2
    fixed = (2 * C + 4 * groups) * 4  # the channel sums, the group sums, mean and rstd
    row_bytes = gn_stride(cv, P) * 16
    rows = -(-N // k)
    resident = fixed + rows * row_bytes <= GN_SMEM_MAX
    return GNPlan(k, rows, P, -(-cv * P // 32) * 32, fixed + (rows * row_bytes if resident else 0), resident)


def plan_cost(plan: GNPlan, B: int, C: int, dtype, held: int) -> float:
    """The plan's modelled microseconds when the card holds `held` of its
    clusters at once: waves x (GN_FIXED_US + a CTA's bytes in and out at
    GN_SM_BYTES_PER_US)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    return -(-B // max(held, 1)) * (GN_FIXED_US + 2 * plan.rows * C * esize / GN_SM_BYTES_PER_US)


def plan_group_norm(B: int, N: int, C: int, dtype, groups: int = 32, k: int | None = None, held=None,
                    threads: int = GN_THREADS) -> GNPlan:
    """K1's launch for x (B, N, C) of `dtype`. A channel vector is 16 bytes
    (VEC = 8 bf16 or 4 fp32 channels) with P row lanes, the largest power of
    two up to GN_MAX_LANES within `threads` threads. k CTAs a sample, one of
    GN_CLUSTERS: among the plans whose CTAs keep their rows in shared memory
    (else k = 16, each CTA reading its rows twice), the least plan_cost, with
    `held(plan)` clusters at once (the card's count; without it, all B). `k`
    forces the cluster size."""
    if k is not None:
        return _plan_k(N, C, dtype, groups, k, threads)
    plans = [_plan_k(N, C, dtype, groups, k, threads) for k in GN_CLUSTERS]
    kept = [p for p in plans if p.resident] or plans[-1:]
    return min(kept, key=lambda p: plan_cost(p, B, C, dtype, held(p) if held else B))


_PLANS: dict = {}


def card_plan(B: int, N: int, C: int, dtype, groups: int = 32) -> GNPlan:
    """plan_group_norm's plan weighed with the card's count of clusters it
    holds at once (cudaOccupancyMaxActiveClusters), made once per shape: the
    plan K1 launches with. The card must hold at least one of its clusters."""
    return _launch_args(B, N, C, dtype, groups)[0]


def _launch_args(B: int, N: int, C: int, dtype, groups: int, plan: GNPlan | None = None):
    """(plan, mvdf_groupnorm's plan arguments, resident, dtype code) for
    `plan`, or for the shape's card_plan, made and cached once per shape: the
    wrapper's host time per call stays a dict lookup."""
    if plan is None:
        key = (B, N, C, dtype, groups)
        hit = _PLANS.get(key)
        if hit is not None:
            return hit
        code = _lib.dtype_code(dtype)
        held = lambda p: _lib.gn_max_clusters(p.k, p.threads, p.smem, p.resident, code)
        plan = plan_group_norm(B, N, C, dtype, groups, held=held)
        if held(plan) < 1:
            raise RuntimeError(f"K1's plan {plan} for {(B, N, C)} {dtype}: the card holds no such cluster")
        hit = _PLANS[key] = _launch_args(B, N, C, dtype, groups, plan)
        return hit
    args = (plan.k, plan.rows, plan.P.bit_length() - 1, gn_stride(C // _vec(dtype), plan.P), plan.threads, plan.smem)
    return plan, args, int(plan.resident), _lib.dtype_code(dtype)


def _affine(t):
    """gamma or beta as K1 reads it: fp32, contiguous, 16-byte aligned (as
    it comes where it already is)."""
    if t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)


def _pick_tile(N: int, C: int):
    """The reference's tile: the largest row tile T dividing N with T*C <=
    _TILE_ELEMS (halving from N), or None where none is a multiple of 8."""
    t = N
    while t * C > _TILE_ELEMS and t % 2 == 0:
        t //= 2
    return t if (t * C <= _TILE_ELEMS and t % 8 == 0) else None


def should_fuse_gn(shape, groups: int) -> bool:
    """The reference's gate (ops/groupnorm.py::should_fuse_gn): group-divisible
    C, and either HW*C <= 2^20 (K1: every UNet GroupNorm of the flagship, the
    VAE's 32^2 maps) or, under MVDF_GN_TILED=1 (read when called), a larger
    map that the reference's tiled form can tile (K7)."""
    n = 1
    for d in shape[1:-1]:
        n *= d
    C = shape[-1]
    if C % groups:
        return False
    if n * C <= _MAX_SLICE_ELEMS:
        return True
    return bool(os.environ.get("MVDF_GN_TILED")) and _pick_tile(n, C) is not None


def group_norm_plain(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """Plain PyTorch version of K1: x (B, N, C) -> same shape and dtype."""
    B, N, C = x.shape
    xs = x.float().reshape(B, N, groups, C // groups)
    mu = xs.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xs * xs).mean(dim=(1, 3), keepdim=True) - mu * mu, min=0.0)
    y = ((xs - mu) * torch.rsqrt(var + eps)).reshape(B, N, C)
    y = y * weight.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def fold_affine(s1, s2, weight, bias, groups: int, n: int, eps: float, clamp: bool):
    """Per-channel fp32 sums s1, s2 (B, C) over n rows -> the folded affine
    (a, b), (B, C) fp32, with normalize(x)*weight + bias == x*a + b: (B, G)
    moments, rstd = rsqrt(E[x^2] - mu^2 + eps), the variance clamped at 0
    where `clamp` (the reference's tiled GroupNorm clamps, its
    conv3x3.gn_fold_affine does not)."""
    B, C = s1.shape
    cg = C // groups
    cnt = float(n * cg)
    mu = s1.reshape(B, groups, cg).sum(-1) / cnt
    var = s2.reshape(B, groups, cg).sum(-1) / cnt - mu * mu
    if clamp:
        var = var.clamp_min(0.0)
    a = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1) * weight.float()
    b = bias.float() - mu.repeat_interleave(cg, dim=-1) * a
    return a, b


def channel_sums_plain(x):
    """Per-(batch, channel) fp32 sum and sum of squares of (B, N, C) x."""
    xs = x.float()
    return xs.sum(1), (xs * xs).sum(1)


def apply_affine_plain(x, a, b, act: str = "none"):
    """y = x*a + b (+SiLU) in fp32 with (B, C) a, b; rounded to x's dtype."""
    y = x.float() * a[:, None, :] + b[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_tiled_plain(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """Plain PyTorch version of K7, the reference's tiled math: per-channel
    fp32 sums, (B, G) moments, the folded affine, x*a + b (+SiLU)."""
    s1, s2 = channel_sums_plain(x)
    a, b = fold_affine(s1, s2, weight, bias, groups, x.shape[1], eps, clamp=True)
    return apply_affine_plain(x, a, b, act)


# K1's steps, stamped by CTA (0, 0) with `stamps` (csrc/groupnorm.cu)
K1_PHASES = ("start copies", "load and stats", "group sums", "cluster sync", "cluster sums", "apply", "cluster wait")


def launch_group_norm(x, weight, bias, groups: int, eps: float, act: str = "none", plan: GNPlan | None = None,
                      stamps=None):
    """Launch csrc/groupnorm.cu's K1 on a CUDA (B, N, C) tensor, on
    plan_group_norm's plan for the shape or on `plan`; counts the call in
    _lib.GN_SHAPES by (B, N, C, act) (not in LAUNCHES). `stamps`, an int64
    CUDA tensor of 8 + 2 B k entries, receives device clock stamps: CTA
    (0, 0)'s K1_PHASES, then each CTA's start and end."""
    B, N, C = x.shape
    plan, args, resident, code = _launch_args(B, N, C, x.dtype, groups, plan)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K1 reads 16-byte vectors: x must be 16-byte aligned")
    y = torch.empty_like(x)
    _lib.call("mvdf_groupnorm", x, _affine(weight), _affine(bias), y, B, N, C, groups, *args, float(eps),
              int(act == "silu"), resident, stamps, code)
    _lib.GN_SHAPES[(B, N, C, act)] += 1
    return y


def launch_fold(x, weight, bias, groups: int, eps: float, clamp: bool):
    """csrc/groupnorm.cu's stats pass on a CUDA (B, N, C) tensor: per-tile
    channel sums, then their sum and the fold in a second kernel. Returns the
    folded affine (a, b), each (B, C) fp32 (no counting)."""
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by {groups} groups")
    x = x.contiguous()
    rows = max(_STATS_MIN_ROWS, -(-N // _STATS_MAX_TILES))
    part = torch.empty(B, -(-N // rows), 2, C, dtype=torch.float32, device=x.device)
    a = torch.empty(B, C, dtype=torch.float32, device=x.device)
    sh = torch.empty_like(a)
    _lib.call("mvdf_gn_stats", x, part, weight.float().contiguous(), bias.float().contiguous(), a, sh,
              B, N, C, groups, rows, float(eps), int(clamp), _lib.dtype_code(x.dtype))
    return a, sh


def launch_apply_affine(x, a, b, act: str = "none"):
    """csrc/groupnorm.cu's apply pass on a CUDA (B, N, C) tensor (no counting)."""
    B, N, C = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    _lib.call("mvdf_gn_apply", x, a.float().contiguous(), b.float().contiguous(), y, B, N, C,
              int(act == "silu"), _lib.dtype_code(x.dtype))
    return y


def launch_group_norm_tiled(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """K7 on a CUDA (B, N, C) tensor: stats pass with the fold, apply pass (no counting)."""
    a, b = launch_fold(x, weight, bias, groups, eps, clamp=True)
    return launch_apply_affine(x, a, b, act)


def group_norm_act(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """GroupNorm(+SiLU) of (B, N, C), dispatched by shape as the reference's
    _gn_fwd_impl: N*C > 2^20 takes the tiled form (K7), or the plain version
    where the reference finds no tile; otherwise K1. A CUDA tensor launches
    the kernel, a CPU tensor takes the kernel's plain version."""
    B, N, C = x.shape
    if N * C > _MAX_SLICE_ELEMS:
        if _pick_tile(N, C) is None:  # the reference computes its XLA twin here
            return group_norm_plain(x, weight, bias, groups, eps, act)
        if not x.is_cuda:
            return group_norm_tiled_plain(x, weight, bias, groups, eps, act)
        y = launch_group_norm_tiled(x, weight, bias, groups, eps, act)
        _lib.LAUNCHES["groupnorm_tiled"] += 1
        return y
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, groups, eps, act)
    y = launch_group_norm(x, weight, bias, groups, eps, act)
    _lib.LAUNCHES["groupnorm"] += 1
    return y
