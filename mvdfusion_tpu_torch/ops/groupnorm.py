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
64^2..256^2), _gn_tiled_impl with _gn_stats_kernel and _gn_apply_kernel:
csrc/groupnorm.cu's stats pass, one launch of one wave of row tiles
(plan_gn_tiled) in which each thread streams a 16-byte channel vector over
its rows, each tile writes its fp32 partial sums and the CTA that completes
a sample adds them in tile order and folds the (B, G) moments into a
per-(batch, channel) affine (the reference folds in XLA between its
kernels); then the apply pass (x*a + b, optional SiLU). No float atomics:
the same result on every run. Two reads and one write of x; bound by
bytes. The stats pass also serves ops/conv3x3.py::gn_fold_affine.

The route (gn_route). On a CPU tensor every GroupNorm takes the reference's
route and the kernel's plain version: K1 where should_fuse_gn passes at
HW*C <= 2^20, K7 where it passes above (MVDF_GN_TILED=1 and a tile from
_pick_tile), the plain version otherwise. On a CUDA tensor every map above
2^20 elements an image whose C K7 takes (a multiple of 8 and of the groups,
at most 1024: whole 16-byte vectors, at most one a thread) launches K7,
whatever MVDF_GN_TILED and _pick_tile say. The reference sends the maps it
refuses to XLA's compiled GroupNorm on the TPU; the card's counterpart of
that would be the plain version, which the port keeps off its main path.
So on the card the only GroupNorms left plain are those whose C neither K1
nor K7 takes (C not a multiple of the groups or of 8, or above 1024 at a
large map); none of them is on the main path.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from mvdfusion_tpu_torch.ops import _lib

_MAX_SLICE_ELEMS = 1 << 20
# the reference's row-tile element budget for its tiled form
# (ops/groupnorm.py:42); with _pick_tile it decides where that form runs, not
# how the CUDA kernels tile (plan_gn_tiled)
_TILE_ELEMS = 1 << 19

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

# K7 (csrc/groupnorm.cu keeps the same constants): threads a CTA, CTAs an SM
# (the kernels' launch bounds), 16-byte loads in flight a thread; its plan
# fills one wave of the card's SMs with row tiles (on the H100, 8 loads were
# no faster, 8 CTAs an SM spilled, and two waves of smaller tiles were slower)
GNT_THREADS = 256
GNT_BLOCKS_PER_SM = 4
GNT_UNROLL = 4
# the largest C that K7 takes in either dtype (fp32: 4 channels a vector,
# one vector a thread)
GNT_MAX_C = 4 * GNT_THREADS


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


class TiledPlan(NamedTuple):
    """K7's launch for one (B, N, C, dtype): `tiles` row tiles a sample of
    `rows` rows each (the last may hold fewer), a multiple of P row lanes a
    channel vector x GNT_UNROLL."""

    rows: int
    tiles: int
    P: int


def plan_gn_tiled(B: int, N: int, C: int, dtype, sms: int = 132) -> TiledPlan:
    """K7's tiles for x (B, N, C) of `dtype` on a card of `sms` SMs: a
    thread owns one 16-byte channel vector (C / VEC of them a row, at most
    GNT_THREADS), P = GNT_THREADS // (C / VEC) row lanes; B x tiles CTAs fill
    at most one wave of GNT_BLOCKS_PER_SM CTAs an SM, each tile a whole
    number of the CTA's P x GNT_UNROLL-row steps."""
    _lib.dtype_code(dtype)
    vec = _vec(dtype)
    if C % vec or not 1 <= C // vec <= GNT_THREADS:
        raise ValueError(f"K7 takes C a multiple of {vec} and at most {vec * GNT_THREADS} in {dtype}, not C={C}")
    P = GNT_THREADS // (C // vec)
    step = P * GNT_UNROLL
    per_sample = max(1, sms * GNT_BLOCKS_PER_SM // B)
    rows = -(-N // per_sample)
    rows = -(-rows // step) * step
    return TiledPlan(rows, -(-N // rows), P)


_TILED_PLANS: dict = {}


def card_tiled_plan(B: int, N: int, C: int, dtype, device) -> TiledPlan:
    """plan_gn_tiled on `device`'s SM count, made once per shape."""
    key = (B, N, C, dtype, device)
    hit = _TILED_PLANS.get(key)
    if hit is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        hit = _TILED_PLANS[key] = plan_gn_tiled(B, N, C, dtype, sms)
    return hit


_FOLD_COUNTS: dict = {}


def _fold_counts(device, B: int):
    """The stats pass's per-sample tile counters for the current stream on
    `device`: zero before each launch (the folding CTA wraps its sample's
    counter back to 0), kept across calls."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counts = _FOLD_COUNTS.get(key)
    if counts is None or counts.numel() < B:
        counts = _FOLD_COUNTS[key] = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
    return counts


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
    map that the reference's tiled form can tile (K7); closed under the
    kernel-off switch."""
    if _lib.switched_off():
        return False
    n = 1
    for d in shape[1:-1]:
        n *= d
    C = shape[-1]
    if C % groups:
        return False
    if n * C <= _MAX_SLICE_ELEMS:
        return True
    return bool(os.environ.get("MVDF_GN_TILED")) and _pick_tile(n, C) is not None


def tiled_takes(C: int, groups: int) -> bool:
    """Whether K7 takes C channels in `groups` groups in either dtype."""
    return C % groups == 0 and C % 8 == 0 and C <= GNT_MAX_C


def gn_route(shape, groups: int, device_type: str, gated: bool = True) -> str:
    """Which form computes GroupNorm of an NHWC or (B, N, C) `shape`: "k1",
    "k7" or "plain". `gated`: the model's GroupNorm32, behind
    should_fuse_gn; else a direct call of group_norm_act, the reference's
    _gn_fwd_impl (K1 up to 2^20 elements an image, K7 above where
    _pick_tile finds a tile, else the plain version). On "cuda" every map
    above 2^20 elements an image goes to K7 where tiled_takes its C and to
    the plain version where not, gated or not (module docstring); on "cpu"
    the route is the reference's. Under the kernel-off switch, "plain"."""
    if _lib.switched_off():
        return "plain"
    n = 1
    for d in shape[1:-1]:
        n *= d
    C = shape[-1]
    if n * C > _MAX_SLICE_ELEMS and device_type == "cuda":
        return "k7" if tiled_takes(C, groups) else "plain"
    if gated and not should_fuse_gn(shape, groups):
        return "plain"
    if n * C <= _MAX_SLICE_ELEMS:
        return "k1"
    return "k7" if _pick_tile(n, C) is not None else "plain"


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
    _lib.no_graph("launch_group_norm", x, weight, bias)
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


def _tiled_operand(x, plan: TiledPlan | None):
    """x contiguous and 16-byte aligned, and K7's plan for it."""
    B, N, C = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K7 reads 16-byte vectors: x must be 16-byte aligned")
    return x, plan or card_tiled_plan(B, N, C, x.dtype, x.device)


def launch_fold(x, weight, bias, groups: int, eps: float, clamp: bool, plan: TiledPlan | None = None):
    """csrc/groupnorm.cu's stats pass on a CUDA (B, N, C) tensor, one launch:
    per-tile channel sums, their sum and the fold by the CTA that completes
    each sample. Returns the folded affine (a, b), each (B, C) fp32 (no
    counting)."""
    _lib.no_graph("launch_fold", x, weight, bias)
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by {groups} groups")
    x, plan = _tiled_operand(x, plan)
    part = torch.empty(B, plan.tiles, 2, C, dtype=torch.float32, device=x.device)
    a = torch.empty(B, C, dtype=torch.float32, device=x.device)
    sh = torch.empty_like(a)
    _lib.call("mvdf_gn_stats", x, part, _fold_counts(x.device, B), _affine(weight), _affine(bias), a, sh,
              B, N, C, groups, plan.rows, plan.tiles, float(eps), int(clamp), _lib.dtype_code(x.dtype))
    return a, sh


def launch_apply_affine(x, a, b, act: str = "none", plan: TiledPlan | None = None):
    """csrc/groupnorm.cu's apply pass on a CUDA (B, N, C) tensor, on the
    stats pass's tiles, each walked from its end (no counting). A
    programmatic dependent launch: it starts during the tail of the kernel
    before it on the stream and loads x ahead of that kernel's end, so x
    must be complete before that kernel starts (as behind launch_fold on
    the same x); a and b are read after it ends."""
    _lib.no_graph("launch_apply_affine", x, a, b)
    B, N, C = x.shape
    x, plan = _tiled_operand(x, plan)
    y = torch.empty_like(x)
    _lib.call("mvdf_gn_apply", x, _affine(a), _affine(b), y, B, N, C, plan.rows, plan.tiles, int(act == "silu"),
              _lib.dtype_code(x.dtype))
    return y


def launch_group_norm_tiled(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """K7 on a CUDA (B, N, C) tensor: stats pass with the fold, apply pass
    launched behind it (no counting)."""
    _lib.no_graph("launch_group_norm_tiled", x, weight, bias)
    x, plan = _tiled_operand(x, None)
    a, b = launch_fold(x, weight, bias, groups, eps, clamp=True, plan=plan)
    return launch_apply_affine(x, a, b, act, plan)


def group_norm_act(x, weight, bias, groups: int, eps: float, act: str = "none", route: str | None = None):
    """GroupNorm(+SiLU) of (B, N, C) on `route` (gn_route's answer; by
    default the ungated route for x's device): "k7" the tiled form, "k1" K1,
    "plain" the plain version. Where _lib.launches, the kernel (its gradient
    the plain version's), else the kernel's plain version."""
    if route is None:
        route = gn_route(x.shape, groups, x.device.type, gated=False)
    if route == "plain":
        return group_norm_plain(x, weight, bias, groups, eps, act)
    tiled = route == "k7"
    plain = group_norm_tiled_plain if tiled else group_norm_plain
    if not _lib.launches(x):
        return plain(x, weight, bias, groups, eps, act)
    launch = launch_group_norm_tiled if tiled else launch_group_norm
    y = _lib.with_plain_backward(lambda x, w, b: launch(x, w, b, groups, eps, act),
                                 lambda x, w, b: plain(x, w, b, groups, eps, act), x, weight, bias)
    _lib.LAUNCHES["groupnorm_tiled" if tiled else "groupnorm"] += 1
    return y
