"""The camera rigs the architectures' traffic generators share.

A pass's scenes are made on the device from the run's seed and the pass's
index by its architecture's `make_pass` (portbench/archs/<arch>.py). A
configuration's `inference` section fixes the rig, the views, the image
size and the sampler; a traffic file (portbench/traffic/<name>.json) fixes
the scenes a pass and the entry that serves them. Every pass of every seed
has the same sizes; the seed changes only the values: the images, the
noise, and on a ring rig each scene's azimuth offset.
"""

from __future__ import annotations

import numpy as np


def look_at(dist, elev_deg, azim_deg):
    """R, T (float32) in the PyTorch3D convention X_view = X_world @ R + T,
    a y-up camera on a sphere looking at the origin."""
    e, a = np.deg2rad(np.asarray(elev_deg, np.float64)), np.deg2rad(np.asarray(azim_deg, np.float64))
    C = np.stack(np.broadcast_arrays(dist * np.cos(e) * np.sin(a), dist * np.sin(e), dist * np.cos(e) * np.cos(a)), -1)
    unit = lambda v: v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-5)
    z = unit(-C)
    x = unit(np.cross(np.broadcast_to([0.0, 1.0, 0.0], z.shape), z))
    y = unit(np.cross(z, x))
    R = np.stack([x, y, z], axis=-1)
    T = -np.einsum("bij,bj->bi", np.transpose(R, (0, 2, 1)), C)
    return R.astype(np.float32), T.astype(np.float32)


def rig(inf: dict, rng: np.random.Generator):
    """One scene's R, T, f, c (S, ...) for the configuration's rig:
    "fixed" (azimuths k 360/S, one elevation) or "ring" (the same with an
    azimuth offset drawn from `rng`)."""
    S = inf["views"]
    azim = np.arange(S) * (360.0 / S) + 90.0
    if inf["rig"] == "ring":
        azim = azim + rng.uniform(0.0, 360.0)
    elif inf["rig"] != "fixed":
        raise ValueError(f"unknown rig {inf['rig']!r}")
    R, T = look_at(inf["distance"], np.full(S, inf["elevation_deg"]), azim)
    f = np.full((S, 2), inf["focal_ndc"], np.float32)
    return R, T, f, np.zeros((S, 2), np.float32)
