"""One ray per latent pixel (torch counterpart of mvdfusion_tpu/geometry/rays.py):
unproject the flipped-sign NDC grid at z=1 and z=2; the difference is the ray
direction (z-normalised, so `length` is view-space depth) and the origin lies
on the z=0 plane."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mvdfusion_tpu_torch.geometry.cameras import Cameras, unproject_points


class RayGrid(NamedTuple):
    origins: torch.Tensor  # (B, H, W, 3)
    directions: torch.Tensor  # (B, H, W, 3), not unit length
    xys: torch.Tensor  # (H, W, 2)


def ndc_pixel_grid(height: int, width: int) -> np.ndarray:
    """x runs 1-1/W -> -1+1/W across columns, y 1-1/H -> -1+1/H down rows."""
    xs = np.linspace(1.0 - 1.0 / width, -1.0 + 1.0 / width, width, dtype=np.float32)
    ys = np.linspace(1.0 - 1.0 / height, -1.0 + 1.0 / height, height, dtype=np.float32)
    y, x = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([x, y], axis=-1)


@functools.lru_cache(maxsize=None)
def pixel_grid(height: int, width: int, device: torch.device) -> torch.Tensor:
    """ndc_pixel_grid as an fp32 tensor on `device`, made once (a copy from
    the host on every call would stall the stream and a CUDA graph)."""
    return torch.as_tensor(ndc_pixel_grid(height, width)).to(device)


def pixel_rays(cams: Cameras, height: int, width: int) -> RayGrid:
    B = len(cams)
    xy = pixel_grid(height, width, cams.R.device)
    xy = xy.reshape(1, height * width, 2).expand(B, -1, -1)
    one = torch.ones_like(xy[..., :1])
    p1 = unproject_points(cams, torch.cat([xy, one], dim=-1))
    p2 = unproject_points(cams, torch.cat([xy, 2.0 * one], dim=-1))
    directions = p2 - p1
    origins = p1 - directions
    return RayGrid(
        origins=origins.reshape(B, height, width, 3),
        directions=directions.reshape(B, height, width, 3),
        xys=xy[0].reshape(height, width, 2),
    )


def rays_to_points(rays: RayGrid, lengths: torch.Tensor) -> torch.Tensor:
    """lengths (B, H, W, D) -> world points (B, H, W, D, 3)."""
    return rays.origins[..., None, :] + rays.directions[..., None, :] * lengths[..., None]


def plucker_coords(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """(d, o x d) per ray, [..., 6]."""
    origins = origins.expand_as(directions)
    return torch.cat([directions, torch.cross(origins, directions, dim=-1)], dim=-1)
