"""NeRF-style harmonic embedding: frequencies omega0 * 2^k, output layout
[sin(all) | cos(all) | x], with the frequency axis interleaved per input dim."""

from __future__ import annotations

import functools

import torch


def harmonic_frequencies(n_harmonic: int = 7, omega0: float = 0.1) -> tuple:
    """omega0 * 2^k as Python floats (the crossview kernel takes them as is)."""
    return tuple(float(omega0 * 2.0**k) for k in range(n_harmonic))


@functools.lru_cache(maxsize=None)
def frequency_tensor(n_harmonic: int, omega0: float, device: torch.device) -> torch.Tensor:
    """harmonic_frequencies as an fp32 tensor on `device`, made once (a copy
    from the host on every call would stall it and a CUDA graph)."""
    return torch.tensor(harmonic_frequencies(n_harmonic, omega0), dtype=torch.float32).to(device)


def harmonic_embed(x: torch.Tensor, n_harmonic: int = 7, omega0: float = 0.1) -> torch.Tensor:
    """[..., d] -> [..., d * (2 * n_harmonic + 1)]."""
    freqs = frequency_tensor(n_harmonic, omega0, x.device)
    xf = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(xf), torch.cos(xf), x], dim=-1)
