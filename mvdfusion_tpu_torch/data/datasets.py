"""Evaluation dataset loaders (counterpart of mvdfusion_tpu/data/datasets.py's
GSO and Wild layouts).

Host-side numpy loaders. Each scene is a dict of float32 numpy arrays in NHWC:
    {index, idx, images (S, H, W, 3), R (S, 3, 3), T (S, 3), f (S, 2),
     c (S, 2), azimuth (S,), elevation (S,)}
Images decode through imageio (PIL where imageio is missing) and resize
through PIL; both are imported where they are used.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig


def _imread(path: str) -> np.ndarray:
    """Read an image to float32 (H, W, C); 8- and 16-bit images are divided
    by 255 (the reference's rule, so 16-bit depth comes out in [0, 257])."""
    try:
        import imageio.v3 as iio

        img = np.asarray(iio.imread(path))
    except ImportError:
        from PIL import Image

        img = np.asarray(Image.open(path))
    if img.dtype in (np.uint8, np.uint16):
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    return img


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size) in float32, one channel at a time (no
    uint8 round trip, so values outside [0, 1] survive)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    from PIL import Image

    chans = [
        np.asarray(
            Image.fromarray(np.ascontiguousarray(img[..., k]), mode="F").resize((size, size), Image.BILINEAR)
        )
        for k in range(img.shape[2])
    ]
    return np.stack(chans, axis=-1).astype(np.float32)


def _composite_white(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> RGB on white where alpha < 0.5."""
    if rgba.shape[-1] < 4:
        return rgba[..., :3]
    rgb = rgba[..., :3].copy()
    rgb[rgba[..., 3] < 0.5] = 1.0
    return rgb


def _scene(index: int, name: str, images: np.ndarray, rig) -> dict:
    R, T, f, c = rig
    return {
        "index": index,
        "idx": name,
        "images": images,
        "R": R,
        "T": T,
        "f": f,
        "c": c,
        "azimuth": AZIMUTHS_16.astype(np.float32),
        "elevation": ELEVATIONS_16.astype(np.float32),
    }


class GSO:
    """Google-Scanned-Objects evaluation set: {root}/{subset}.json lists scene
    dirs; each holds RGBA pngs 000.png..; views 0..15 form the fixed 16-view
    rig at elevation 30deg."""

    n_views = 16

    def __init__(self, root: str, subset: str = "test", image_size: int = 256, **_):
        self.root = root
        self.image_size = image_size
        with open(os.path.join(root, f"{subset}.json")) as fp:
            self.scenes = json.load(fp)
        self.rig = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index: int) -> dict:
        scene_dir = os.path.join(self.root, self.scenes[index])
        paths = [os.path.join(scene_dir, f"{i:03d}.png") for i in range(self.n_views)]
        imgs = [_composite_white(_resize(_imread(p), self.image_size)) for p in paths]
        return _scene(index, self.scenes[index], np.stack(imgs), self.rig)


class Wild:
    """One segmented RGBA image -> 16 identical frames on the fixed rig: the
    input view conditions, the other 15 are pure generation targets. The
    scene list is {root}/{subset}.json, else the sorted files of root."""

    n_views = 16

    def __init__(self, root: str, subset: str = "test", image_size: int = 256, **_):
        self.root = root
        self.image_size = image_size
        subset_path = os.path.join(root, f"{subset}.json")
        if os.path.exists(subset_path):
            with open(subset_path) as fp:
                self.scenes = json.load(fp)
        else:
            self.scenes = sorted(os.listdir(root))
        self.rig = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index: int) -> dict:
        rgba = _resize(_imread(os.path.join(self.root, self.scenes[index])), self.image_size)
        img = _composite_white(rgba)
        return _scene(index, self.scenes[index], np.repeat(img[None], self.n_views, axis=0), self.rig)
