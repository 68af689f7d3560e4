"""K1: GroupNorm(32) (+SiLU) over (B, N, C) channels-last activations.

Replaces mvdfusion_tpu/ops/groupnorm.py::_gn_kernel (via _gn_fwd_impl). The
kernel is csrc/groupnorm.cu: one block per (group, batch), fp32 sum and sum
of squares, variance E[x^2] - E[x]^2 clamped at 0, affine, optional SiLU.
It is bound by bytes on the H100 (one read, one write per element).
"""

from __future__ import annotations

import torch

from mvdfusion_tpu_torch.ops import _lib

_MAX_SLICE_ELEMS = 1 << 20


def should_fuse_gn(shape, groups: int) -> bool:
    """The reference's gate: group-divisible C and HW*C <= 2^20 (every UNet
    GroupNorm of the flagship; the image-sized VAE maps stay plain)."""
    n = 1
    for d in shape[1:-1]:
        n *= d
    C = shape[-1]
    return C % groups == 0 and n * C <= _MAX_SLICE_ELEMS


def group_norm_plain(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """Plain PyTorch version: x (B, N, C) -> same shape and dtype."""
    B, N, C = x.shape
    xs = x.float().reshape(B, N, groups, C // groups)
    mu = xs.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xs * xs).mean(dim=(1, 3), keepdim=True) - mu * mu, min=0.0)
    y = ((xs - mu) * torch.rsqrt(var + eps)).reshape(B, N, C)
    y = y * weight.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def launch_group_norm(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """Launch csrc/groupnorm.cu on a CUDA (B, N, C) tensor (no counting)."""
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


def group_norm_act(x, weight, bias, groups: int, eps: float, act: str = "none"):
    """GroupNorm(+SiLU) of (B, N, C): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, groups, eps, act)
    y = launch_group_norm(x, weight, bias, groups, eps, act)
    _lib.LAUNCHES["groupnorm"] += 1
    return y
