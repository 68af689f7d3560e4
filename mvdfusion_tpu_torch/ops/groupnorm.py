"""K1 and K7: GroupNorm(32) (+SiLU) over (B, N, C) channels-last activations.

K1 replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (via _gn_fwd_impl):
csrc/groupnorm.cu's gn_kernel, one block per (group, batch), fp32 sum and
sum of squares, variance E[x^2] - E[x]^2 clamped at 0, affine, optional SiLU,
for slices with HW*C <= 2^20. It is bound by bytes on the H100 (one read, one
write per element).

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


def launch_group_norm(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """Launch csrc/groupnorm.cu's K1 on a CUDA (B, N, C) tensor (no counting)."""
    B, N, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by {groups} groups")
    x = x.contiguous()
    y = torch.empty_like(x)
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    _lib.call(
        "mvdf_groupnorm", x, w, b, y, B, N, C, groups,
        float(eps), int(act == "silu"), _lib.dtype_code(x.dtype),
    )
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
