"""Bilinear grid sampling with torch `grid_sample` semantics (bilinear, border
padding, align_corners=True) on NHWC maps, as an explicit 4-tap gather.
Callers pass the NEGATED NDC xy (geometry convention)."""

from __future__ import annotations

import torch


def bilinear_taps(xy: torch.Tensor, H: int, W: int):
    """xy (..., 2) grid coords -> (flat indices (..., 4), weights (..., 4) fp32)."""
    x = torch.clamp((xy[..., 0].float() + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((xy[..., 1].float() + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=-1)
    w = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], dim=-1)
    return idx, w


def bilinear_gather(features: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """features (B, H, W, C), xy (B, N, 2) -> (B, N, C) fp32: the 4-tap
    interpolation with the weights rounded to the features' dtype (as the
    reference's one-hot matmul sampler rounds its weight matrix), summed in
    fp32."""
    B, H, W, C = features.shape
    N = xy.shape[1]
    idx, w = bilinear_taps(xy, H, W)  # (B, N, 4)
    flat = features.reshape(B, H * W, C).float()
    g = torch.gather(flat, 1, idx.reshape(B, N * 4, 1).expand(B, N * 4, C)).reshape(B, N, 4, C)
    return (g * w.to(features.dtype).float()[..., None]).sum(dim=2)


def grid_sample(features: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """bilinear_gather in the features' dtype."""
    return bilinear_gather(features, xy).to(features.dtype)
