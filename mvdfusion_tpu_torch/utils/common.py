"""Small shared helpers."""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1] with clipping."""
    return torch.clamp(x * 2.0 - 1.0, -1.0, 1.0)


def unnormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1] with clipping."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def split_list(a, n: int):
    """Split a list into n contiguous parts, the first len(a) % n one longer
    (the reference's per-rank split of an eval scene list)."""
    k, m = divmod(len(a), n)
    return [a[i * k + min(i, m) : (i + 1) * k + min(i + 1, m)] for i in range(n)]
