"""Evaluation metrics (counterpart of mvdfusion_tpu/utils/metrics.py).

numpy in, Python floats out. `cross_view_consistency` reprojects through the
port's own geometry (torch on the CPU).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from mvdfusion_tpu_torch.geometry.cameras import make_cameras, transform_points_ndc
from mvdfusion_tpu_torch.geometry.gridsample import grid_sample
from mvdfusion_tpu_torch.geometry.rays import pixel_rays, rays_to_points


class AverageMeter:
    """Running average; with `length` > 0 a sliding window, else cumulative."""

    def __init__(self, length: int = 0):
        self.length = length
        self.reset()

    def reset(self):
        self._window = deque(maxlen=self.length) if self.length > 0 else None
        self.count = 0
        self.sum = 0.0
        self.val = 0.0
        self.avg = 0.0

    def update(self, val: float, num: int = 1):
        self.val = val
        if self._window is not None:
            if num != 1:
                raise ValueError("a windowed AverageMeter takes one value at a time")
            self._window.append(val)
            self.avg = float(np.mean(self._window))
        else:
            self.sum += val * num
            self.count += num
            self.avg = self.sum / self.count


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """PSNR between two images in [0, max_val], in float64."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' filter over the leading two axes of (H, W, C), as
    two banded matrix products (BLAS matmuls)."""
    n = len(k)
    H, W, C = img.shape
    My = np.zeros((H - n + 1, H))
    Mx = np.zeros((W - n + 1, W))
    for i in range(n):
        My[np.arange(H - n + 1), np.arange(H - n + 1) + i] += k[i]
        Mx[np.arange(W - n + 1), np.arange(W - n + 1) + i] += k[i]
    out = (My @ img.reshape(H, W * C)).reshape(H - n + 1, W, C)
    return np.matmul(Mx, out)


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Single-scale SSIM (11x11 Gaussian, sigma 1.5, K1 0.01, K2 0.03),
    averaged over channels; inputs (H, W, C) or (B, H, W, C)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 4:
        return float(np.mean([ssim(x, y, max_val) for x, y in zip(a, b)]))
    k = _gaussian_kernel()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    var_a = _filter2(a * a, k) - mu_a**2
    var_b = _filter2(b * b, k) - mu_b**2
    cov = _filter2(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s))


def cross_view_consistency(
    rgb: np.ndarray,
    depth_stored: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    f: np.ndarray,
    c: np.ndarray = None,
    depth_scale: float = 2.0,
    depth_shift: float = 0.5,
    tau: float = 0.1,
    bg_threshold: float = 0.98,
) -> dict:
    """The paper's cross-view consistency of a set of generated RGB-D views.

    For every ordered view pair (i, j): unproject view i's eroded-foreground
    pixels at its own predicted depth (pixel_rays -> rays_to_points, the
    chain GridAttn uses), project them into view j, sample view j's depth
    there (negated-xy grid_sample) and classify by the gap to the point's
    view-j depth: occluded (gap < -tau, excluded), agreeing (|gap| <= tau),
    violating (gap > tau: j sees through the surface i claims). Photometric
    MAE of view i's RGB against view j's sampled RGB over the agreeing set.

    rgb (B, h, w, 3) in [0, 1] and depth_stored (B, h, w, 1) in the stored
    [0, 1] convention (metric z = stored * scale + shift), at one resolution.
    Returns {photo_mae, depth_agree_rate = agree / (agree + viol),
    covis_frac = agree / (agree + viol + occluded), n_pairs}.
    """
    rgb = np.asarray(rgb, np.float32)
    depth_stored = np.asarray(depth_stored, np.float32)
    B, h, w, _ = rgb.shape
    cams = make_cameras(R, T, f, c)
    rays = pixel_rays(cams, h, w)
    z_metric = torch.as_tensor(depth_stored[..., 0] * depth_scale + depth_shift)  # (B, h, w)
    pts = rays_to_points(rays, z_metric[..., None]).reshape(B, h * w, 3)
    fg2 = depth_stored[..., 0] < bg_threshold
    pad = np.pad(fg2, ((0, 0), (1, 1), (1, 1)), constant_values=False)
    fg2 = fg2 & pad[:, :-2, 1:-1] & pad[:, 2:, 1:-1] & pad[:, 1:-1, :-2] & pad[:, 1:-1, 2:]
    fg = fg2.reshape(B, -1)
    rgb_flat = rgb.reshape(B, -1, 3)
    trgb = torch.as_tensor(rgb)
    tdep = torch.as_tensor(depth_stored)

    photo_n = agree_n = viol_n = occl_n = 0.0
    for i in range(B):
        ndc = transform_points_ndc(cams, pts[i : i + 1])  # i's cloud in every view
        xy = ndc[..., :2]
        zj = (1.0 / ndc[..., 2]).numpy()  # view-space z of i's points in each view
        samp_rgb = grid_sample(trgb, -xy).numpy()  # (B, N, 3)
        samp_dep = grid_sample(tdep, -xy).numpy()[..., 0] * depth_scale + depth_shift
        xy = xy.numpy()
        inb = (np.abs(xy[..., 0]) < 1.0 - 2.0 / w) & (np.abs(xy[..., 1]) < 1.0 - 2.0 / h) & (zj > 0.0)
        valid = inb & fg[i][None, :]
        valid[i] = False  # the self pair
        gap = samp_dep - zj
        agree = valid & (np.abs(gap) <= tau)
        viol = valid & (gap > tau)
        occl = valid & (gap < -tau)
        pe = np.abs(samp_rgb - rgb_flat[i][None]).mean(-1)
        photo_n += float((pe * agree).sum())
        agree_n += float(agree.sum())
        viol_n += float(viol.sum())
        occl_n += float(occl.sum())

    eps = 1e-9
    return dict(
        photo_mae=photo_n / max(agree_n, eps),
        depth_agree_rate=agree_n / max(agree_n + viol_n, eps),
        covis_frac=agree_n / max(agree_n + viol_n + occl_n, eps),
        n_pairs=B * (B - 1),
    )


def perceptual_distance(a: np.ndarray, b: np.ndarray) -> float:
    """1 - multi-scale SSIM over 3 dyadic scales (the reference package's
    offline stand-in for LPIPS, whose pretrained features are not shipped).
    Lower is better."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    vals = []
    for _ in range(3):
        vals.append(ssim(a, b))
        if min(a.shape[-3], a.shape[-2]) < 24:
            break
        pool = lambda x: (
            x[..., : x.shape[-3] // 2 * 2, : x.shape[-2] // 2 * 2, :]
            .reshape(*x.shape[:-3], x.shape[-3] // 2, 2, x.shape[-2] // 2, 2, x.shape[-1])
            .mean(axis=(-4, -2))
        )
        a, b = pool(a), pool(b)
    return float(1.0 - np.mean(vals))
