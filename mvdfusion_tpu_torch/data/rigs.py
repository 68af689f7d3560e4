"""Fixed camera rigs of the dataset layouts (torch-free numpy counterpart of
mvdfusion_tpu/data/rigs.py).

  * 16 views at elevation 30deg, azimuths in 22.5deg steps, dist 1.5, y-up
    look_at with azim + 90deg, NDC focal 2.1875 = 35mm lens / (32mm / 2)
    sensor: the GSO and Wild evaluation rig.
  * 64 Objaverse renders over 8 elevation rings x 8-16 azimuths; training
    uses the 16-view ring at elevation 30deg (indices 40..55).
"""

from __future__ import annotations

import numpy as np

from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform

FOCAL_NDC = 35.0 * 2.0 / 32.0  # 2.1875
RIG_DIST = 1.5

AZIMUTHS_16 = np.arange(16) * (2.0 * np.pi / 16.0)
ELEVATIONS_16 = np.full(16, np.deg2rad(30.0))

# Objaverse 64-view grid: elevation rings at -10, 0 (x16), 10, 20, 30 (x16), 40 deg
_ELEV_DEG = [-10.0] * 8 + [0.0] * 16 + [10.0] * 8 + [20.0] * 8 + [30.0] * 16 + [40.0] * 8
_AZIM = (
    list((np.arange(8) + 0.5) * (2 * np.pi / 8))
    + list(np.arange(16) * (2 * np.pi / 16))
    + list((np.arange(8) + 0.5) * (2 * np.pi / 8))
    + list(np.arange(8) * (2 * np.pi / 8))
    + list(np.arange(16) * (2 * np.pi / 16))
    + list((np.arange(8) + 0.5) * (2 * np.pi / 8))
)
AZIMUTHS_B64 = np.asarray(_AZIM)
ELEVATIONS_B64 = np.deg2rad(np.asarray(_ELEV_DEG))

# the fixed-elevation training slice: the 16-view ring at 30deg elevation
OBJAVERSE_TRAIN_RING = np.arange(40, 56)


def fixed_rig(azimuths: np.ndarray, elevations: np.ndarray, dist: float = RIG_DIST):
    """R, T, f, c (float32 numpy) for the y-up rig: look_at(azim_deg + 90, elev_deg)."""
    R, T = look_at_view_transform(
        dist=dist,
        azim=np.rad2deg(azimuths) + 90.0,
        elev=np.rad2deg(elevations),
        up=(0.0, 1.0, 0.0),
    )
    n = len(R)
    f = np.full((n, 2), FOCAL_NDC, np.float32)
    c = np.zeros((n, 2), np.float32)
    return R, T, f, c
