"""Artifact writers: the evaluation's jpg strips, gifs and depth maps, and
training's sample grid and loss curve (counterpart of
mvdfusion_tpu/utils/vis.py, with the same file names). numpy and PIL; PIL is
imported where an image is written."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(_to_u8(img)).save(path)


def save_strip(path: str, images: np.ndarray) -> None:
    """(B, H, W, 3) -> one horizontal strip."""
    save_image(path, np.concatenate(list(images), axis=1))


def save_gif(path: str, frames: Sequence[np.ndarray], duration_s: float = 0.2) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pil = [Image.fromarray(_to_u8(f)) for f in frames]
    pil[0].save(path, save_all=True, append_images=pil[1:], duration=int(duration_s * 1000), loop=0)


def depth_to_rgb(depth: np.ndarray) -> np.ndarray:
    """(..., H, W, 1) depth in [0, 1] -> 3-channel grayscale."""
    return np.repeat(np.clip(depth, 0.0, 1.0), 3, axis=-1)


def save_depth_artifacts(jpg_path: str, pred_depth, input_depth, gt_depth) -> None:
    """Depth strip [input | predictions] as png and raw npy, and a gif of
    the predictions. `gt_depth` is accepted for the reference's signature
    and, as there, not drawn."""
    vis_pred = depth_to_rgb(pred_depth)
    vis_in = depth_to_rgb(input_depth)
    strip = np.concatenate([np.concatenate(list(vis_in), axis=1), np.concatenate(list(vis_pred), axis=1)], axis=1)
    save_image(jpg_path.replace(".jpg", "_depth.png"), strip)
    np.save(jpg_path.replace(".jpg", "_depth.npy"), strip)
    save_gif(jpg_path.replace(".jpg", "_depth.gif"), list(vis_pred))


def save_eval_artifacts(
    save_dir: str,
    global_step: int,
    scene_idx: int,
    pred_rgb: np.ndarray,
    gt_rgb: np.ndarray,
    pred_depth: Optional[np.ndarray] = None,
    input_depth: Optional[np.ndarray] = None,
    gt_depth: Optional[np.ndarray] = None,
) -> str:
    """One scene's artifacts: the prediction strip (jpg), a gif of
    [gt | prediction] frames and the depth artifacts; returns the jpg path."""
    n = len(pred_rgb)
    jpg = os.path.join(save_dir, f"{global_step:07d}_eval_{scene_idx:03d}_n{n}.jpg")
    save_strip(jpg, pred_rgb)
    save_gif(jpg.replace(".jpg", ".gif"), [np.concatenate([gt_rgb[j], pred_rgb[j]], axis=1) for j in range(n)])
    if pred_depth is not None:
        save_depth_artifacts(jpg, pred_depth, input_depth, gt_depth)
    return jpg


def _nearest_upsample(x: np.ndarray, factor: int) -> np.ndarray:
    return np.repeat(np.repeat(x, factor, axis=-3), factor, axis=-2)


def save_train_vis_grid(
    path: str,
    noise_rgb: np.ndarray,  # (B, H, W, 3) decoded noisy latents
    pred_rgb: np.ndarray,  # (B, H, W, 3) decoded sample
    gt_rgb: np.ndarray,  # (B, H, W, 3)
    pred_depth: np.ndarray,  # (B, h, w, 1) in [0, 1]
    gt_depth: np.ndarray,  # (B, h, w, 1)
    input_rgb: Optional[np.ndarray] = None,  # (1, H, W, 3)
    input_depth: Optional[np.ndarray] = None,  # (1, h, w, 1)
    concat_input: bool = False,
) -> None:
    """Training's sample grid: five stacked rows [noise | pred | gt |
    pred_depth | gt_depth], views side by side, depths nearest-upsampled to
    the image resolution; with concat_input the input view leads each row."""
    H = pred_rgb.shape[1]
    factor = H // pred_depth.shape[1]
    row = lambda imgs: np.concatenate(list(np.clip(imgs, 0.0, 1.0)), axis=1)
    d3 = lambda d: depth_to_rgb(_nearest_upsample(d, factor))
    rows = [row(noise_rgb), row(pred_rgb), row(gt_rgb), row(d3(pred_depth)), row(d3(gt_depth))]
    if concat_input and input_rgb is not None:
        pre = [row(input_rgb)] * 3 + [row(d3(input_depth))] * 2
        rows = [np.concatenate([p, r], axis=1) for p, r in zip(pre, rows)]
    save_image(path, np.concatenate(rows, axis=0))


def save_loss_plot(path: str, losses, interval: int = 1, size=(640, 320)) -> None:
    """The loss curve as a png drawn with PIL: losses at steps interval,
    2 interval, ... as a polyline over the value range, axes on the left and
    bottom."""
    from PIL import Image, ImageDraw

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    W, H = size
    pad = 32
    img = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(img)
    draw.line([(pad, pad // 2), (pad, H - pad), (W - pad // 2, H - pad)], fill="black")
    arr = np.asarray(losses, np.float64)
    arr = arr[np.isfinite(arr)]
    if len(arr):
        lo, hi = float(arr.min()), float(arr.max())
        span = hi - lo or 1.0
        xs = np.linspace(pad, W - pad // 2, max(len(arr), 2))[: len(arr)]
        ys = (H - pad) - (arr - lo) / span * (H - 1.5 * pad)
        pts = list(zip(xs.tolist(), ys.tolist()))
        draw.line(pts if len(pts) > 1 else pts * 2, fill=(31, 119, 180), width=2)
        draw.text((pad + 4, 2), f"loss {hi:.4g} .. {lo:.4g}", fill="black")
        draw.text((W - 6 * pad, H - pad + 8), f"step {len(arr) * interval}", fill="black")
    img.save(path)
