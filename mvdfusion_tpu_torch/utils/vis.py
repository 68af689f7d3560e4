"""Evaluation artifact writers: jpg strips, gifs, depth maps (counterpart of
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
