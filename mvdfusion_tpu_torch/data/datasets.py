"""Dataset loaders (counterpart of mvdfusion_tpu/data/datasets.py): the GSO
and Wild evaluation layouts and the Objaverse training renders.

Host-side numpy loaders. Each scene is a dict of float32 numpy arrays in NHWC:
    {index, idx, images (S, H, W, 3), R (S, 3, 3), T (S, 3), f (S, 2),
     c (S, 2), azimuth (S,), elevation (S,) [, depths (S, H, W, 1),
     masks (S, H, W, 1)]}

Images take the JAX package's route: the native loader (native/loader.cc:
decode, area-average downscale or half-pixel bilinear upscale, the alpha <
0.5 white composite after the resize) for GSO's RGBA pngs and Objaverse's
rgb jpgs and 16-bit depth pngs where the library builds, else PIL (decode,
then PIL's bilinear resize, then the composite); Objaverse's masks and the
Wild images always take PIL, imported where it is used. Two departures from
the JAX package, which swallows every exception of its native route:
where the library cannot be built the reason is printed on stderr once and
the reads take PIL; a file the built decoder refuses raises
native.DecodeError naming it, and does not fall back to PIL.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from mvdfusion_tpu_torch import native
from mvdfusion_tpu_torch.data.rigs import (
    AZIMUTHS_16,
    AZIMUTHS_B64,
    ELEVATIONS_16,
    ELEVATIONS_B64,
    OBJAVERSE_TRAIN_RING,
    fixed_rig,
)


_told = False  # the native loader's absence is printed once a process


def _native_batch(paths, size: int, white_composite: bool, channels: int = 3):
    """(N, size, size, channels) through the native loader, or None where
    the library cannot be built (the caller takes PIL)."""
    global _told
    if not native.available():
        if not _told:
            _told = True
            print(f"mvdfusion_tpu_torch.data: the native image loader is unavailable, images decode through PIL: "
                  f"{native.reason()}", file=sys.stderr)
        return None
    return native.decode_batch(paths, size, size, channels, white_composite=white_composite, n_threads=4)


def _imread(path: str) -> np.ndarray:
    """Read an image to float32 (H, W, C); 8- and 16-bit images are divided
    by 255 (the reference's rule, so 16-bit depth comes out in [0, 257])."""
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im)
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
        imgs = _native_batch(paths, self.image_size, white_composite=True)
        if imgs is None:
            imgs = np.stack([_composite_white(_resize(_imread(p), self.image_size)) for p in paths])
        return _scene(index, self.scenes[index], imgs, self.rig)


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


class Objaverse:
    """Objaverse training renders: {root}/subset_list/{subset}_{stage}.json
    lists scene uids; {root}/{subset}/{uid}/views/ holds 64 renders
    {i:03d}_rgb.jpg (with {i:03d}_depth.png and {i:03d}_mask.jpg) on the
    64-view grid of data/rigs.py. fix_elevation takes the 16-view ring at
    30deg (OBJAVERSE_TRAIN_RING), else all 64. `sample_batch_size` and the
    other reference keys are accepted and unused (the reference reads it
    only without fix_elevation)."""

    def __init__(
        self,
        root: str,
        subset: str = "400k",
        stage: str = "train",
        image_size: int = 256,
        fix_elevation: bool = True,
        load_depth: bool = False,
        load_mask: bool = False,
        **_,
    ):
        self.root = root
        self.subset = subset
        self.stage = stage
        self.image_size = image_size
        self.fix_elevation = fix_elevation
        self.load_depth = load_depth
        self.load_mask = load_mask
        with open(os.path.join(root, "subset_list", f"{subset}_{stage}.json")) as fp:
            self.scenes = json.load(fp)
        self.R, self.T, self.f, self.c = fixed_rig(AZIMUTHS_B64, ELEVATIONS_B64)

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, index: int) -> dict:
        scene_dir = os.path.join(self.root, self.subset, self.scenes[index], "views")
        idxs = OBJAVERSE_TRAIN_RING if self.fix_elevation else np.arange(64)

        def read(suffix, chans, native_route=True):
            paths = [os.path.join(scene_dir, f"{i:03d}_{suffix}") for i in idxs]
            out = _native_batch(paths, self.image_size, False, chans) if native_route else None
            if out is None:
                out = np.stack([_resize(_imread(p), self.image_size)[..., :chans] for p in paths])
            return out

        out = {
            "index": index,
            "idx": self.scenes[index],
            "images": read("rgb.jpg", 3),
            "R": self.R[idxs],
            "T": self.T[idxs],
            "f": self.f[idxs],
            "c": self.c[idxs],
            "azimuth": AZIMUTHS_B64[idxs].astype(np.float32),
            "elevation": ELEVATIONS_B64[idxs].astype(np.float32),
        }
        if self.load_depth:
            out["depths"] = read("depth.png", 1)
        if self.load_mask:
            out["masks"] = read("mask.jpg", 1, native_route=False)  # PIL, as in the JAX package
        return out
