"""Image resampling on NHWC tensors: exact area downsampling, nearest 2x
upsampling, and bicubic (A=-0.75) align_corners=True resizing as two dense
matrix products with a precomputed weight matrix."""

from __future__ import annotations

import functools

import numpy as np
import torch


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool of NHWC by an integer factor, accumulated in fp32."""
    if factor == 1:
        return x
    B, H, W, C = x.shape
    assert H % factor == 0 and W % factor == 0, (H, W, factor)
    x6 = x.reshape(B, H // factor, factor, W // factor, factor, C)
    return x6.float().mean(dim=(2, 4)).to(x.dtype)


def nearest_upsample2x(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    return np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=16)
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) align_corners=True bicubic interpolation matrix, border taps
    replicated."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    M = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(M, (np.arange(out_size), idx), _cubic_kernel(frac - tap))
    return M.astype(np.float32)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) fp32."""
    B, H, W, C = x.shape
    My = torch.as_tensor(_bicubic_matrix(H, out_h), device=x.device)
    Mx = torch.as_tensor(_bicubic_matrix(W, out_w), device=x.device)
    x = torch.einsum("oh,bhwc->bowc", My, x.float())
    return torch.einsum("ow,bhwc->bhoc", Mx, x)
