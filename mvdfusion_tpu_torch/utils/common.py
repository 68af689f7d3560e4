"""Small shared helpers."""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] with clipping."""
    return torch.clamp(x * 2.0 - 1.0, -1.0, 1.0)


def unnormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1] with clipping."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)

