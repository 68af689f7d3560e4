"""Perspective cameras in the PyTorch3D convention (torch counterpart of
mvdfusion_tpu/geometry/cameras.py).

  * Row-vector rotations: X_view = X_world @ R + T; camera center C = -T @ R^T.
  * NDC: x_ndc = fx * x_view / z_view + px, with +x left and +y up, hence the
    negated xy at every grid-sample site.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Cameras(NamedTuple):
    """R (B,3,3) row-vector rotation, T (B,3), focal_length (B,2) and
    principal_point (B,2) in NDC."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor

    def __len__(self) -> int:
        return self.R.shape[0]


def make_cameras(R, T, focal_length, principal_point=None, device=None) -> Cameras:
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    T = torch.as_tensor(T, dtype=torch.float32, device=R.device)
    B = R.shape[0]
    f = torch.as_tensor(focal_length, dtype=torch.float32, device=R.device).expand(B, 2)
    if principal_point is None:
        c = torch.zeros(B, 2, device=R.device)
    else:
        c = torch.as_tensor(principal_point, dtype=torch.float32, device=R.device).expand(B, 2)
    return Cameras(R, T, f.contiguous(), c.contiguous())


def camera_slice(cams: Cameras, indices) -> Cameras:
    if isinstance(indices, (list, tuple)):
        indices = torch.as_tensor(indices, device=cams.R.device)
    return Cameras(*(a[indices] for a in cams))


def concat_cameras(camera_list: Sequence[Cameras]) -> Cameras:
    """One batch of the batches in `camera_list`, in order."""
    return Cameras(*(torch.cat(parts) for parts in zip(*camera_list)))


def camera_center(cams: Cameras) -> torch.Tensor:
    """World-space centers C = -T @ R^T, (B, 3)."""
    return -torch.einsum("bj,bkj->bk", cams.T, cams.R)


def world_to_view(cams: Cameras, points: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnj,bjk->bnk", points, cams.R) + cams.T[:, None, :]


def view_to_world(cams: Cameras, points: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnj,bkj->bnk", points - cams.T[:, None, :], cams.R)


def transform_points_ndc(cams: Cameras, points: torch.Tensor) -> torch.Tensor:
    """World points (B or 1, N, 3) -> (x_ndc, y_ndc, 1/z_view), (B, N, 3)."""
    if points.shape[0] == 1 and cams.R.shape[0] != 1:
        points = points.expand(cams.R.shape[0], *points.shape[1:])
    xv = world_to_view(cams, points)
    z = xv[..., 2:3]
    xy = cams.focal_length[:, None, :] * xv[..., :2] / z + cams.principal_point[:, None, :]
    return torch.cat([xy, 1.0 / z], dim=-1)


def unproject_points(cams: Cameras, xy_depth: torch.Tensor) -> torch.Tensor:
    """(x_ndc, y_ndc, z_view) (B, N, 3) -> world points."""
    xy = xy_depth[..., :2]
    z = xy_depth[..., 2:3]
    xy_view = (xy - cams.principal_point[:, None, :]) * z / cams.focal_length[:, None, :]
    return view_to_world(cams, torch.cat([xy_view, z], dim=-1))


def relative_cameras(cams: Cameras, query_idx) -> Cameras:
    """R_i <- Rq^T @ R_i, T unchanged (center_at_origin=False)."""
    if isinstance(query_idx, (list, tuple)):
        query_idx = torch.as_tensor(query_idx, device=cams.R.device)
    Rq = cams.R[query_idx]
    if Rq.ndim == 3:
        Rq = Rq[0]
    R_rel = torch.einsum("ji,bjk->bik", Rq, cams.R)
    return Cameras(R_rel, cams.T, cams.focal_length, cams.principal_point)


def normalize_cameras(cams: Cameras, distance: float = 3.5) -> Cameras:
    """T rescaled so that the mean distance of the camera centres from the
    origin is `distance` (look_at_optical_center=False). A new Cameras, not
    `_replace`: the NamedTuple's __len__ counts cameras, which _replace's
    field check would read."""
    scale = distance / torch.linalg.norm(camera_center(cams), dim=1).mean()
    return Cameras(cams.R, cams.T * scale, cams.focal_length, cams.principal_point)


# look_at rigs (host-side numpy, PyTorch3D look_at_view_transform semantics)


def camera_position_from_spherical_angles(dist, elev, azim, degrees: bool = True) -> np.ndarray:
    dist = np.asarray(dist, np.float64)
    elev = np.asarray(elev, np.float64)
    azim = np.asarray(azim, np.float64)
    if degrees:
        elev = np.deg2rad(elev)
        azim = np.deg2rad(azim)
    x = dist * np.cos(elev) * np.sin(azim)
    y = dist * np.sin(elev)
    z = dist * np.cos(elev) * np.cos(azim)
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def look_at_rotation(camera_position, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> np.ndarray:
    camera_position = np.atleast_2d(np.asarray(camera_position, np.float64))
    at = np.broadcast_to(np.asarray(at, np.float64), camera_position.shape)
    up = np.broadcast_to(np.asarray(up, np.float64), camera_position.shape)

    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-5)

    z_axis = _norm(at - camera_position)
    x_axis = _norm(np.cross(up, z_axis))
    y_axis = _norm(np.cross(z_axis, x_axis))
    degenerate = np.isclose(x_axis, 0.0, atol=5e-3).all(axis=-1, keepdims=True)
    x_axis = np.where(degenerate, _norm(np.cross(y_axis, z_axis)), x_axis)
    return np.stack([x_axis, y_axis, z_axis], axis=-1)


def look_at_view_transform(
    dist=1.0, elev=0.0, azim=0.0, up=(0.0, 1.0, 0.0), at=(0.0, 0.0, 0.0), eye=None, degrees=True
):
    """R, T (float32 numpy) such that X_view = X_world @ R + T."""
    if eye is not None:
        C = np.atleast_2d(np.asarray(eye, np.float64))
    else:
        C = np.atleast_2d(camera_position_from_spherical_angles(dist, elev, azim, degrees=degrees))
    R = look_at_rotation(C, at=at, up=up)
    T = -np.einsum("bij,bj->bi", np.transpose(R, (0, 2, 1)), C)
    return R.astype(np.float32), T.astype(np.float32)
