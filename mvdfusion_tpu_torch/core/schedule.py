"""Diffusion noise schedules (torch counterpart of mvdfusion_tpu/core/schedule.py).

The SD linear-sqrt DDPM tables (fp64 math on the host, fp32 tables), the
DDIM sub-schedule at any eta on uniform or quad timesteps with the +1
offset, one DDIM update, and
the training-time forward noising (`q_sample`) and its inverse
(`predict_start_from_noise`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DDPMSchedule(NamedTuple):
    """Per-timestep DDPM tables, each (T,) float32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_ddpm_schedule(
    timesteps: int = 1000,
    linear_start: float = 0.00085,
    linear_end: float = 0.0120,
    device="cpu",
) -> DDPMSchedule:
    """betas = linspace(s^0.5, e^0.5, T)^2, computed in fp64, stored fp32."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps, dtype=np.float64) ** 2
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = np.concatenate([np.ones(1, dtype=np.float64), abar[:-1]])
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    post_log_var = np.clip(np.log(np.clip(post_var, 1e-20, None)), -10, None)
    return DDPMSchedule(
        betas=_f32(betas, device),
        alphas=_f32(alphas, device),
        alphas_cumprod=_f32(abar, device),
        sqrt_alphas_cumprod=_f32(np.sqrt(abar), device),
        sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - abar), device),
        sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / abar), device),
        sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / abar - 1.0), device),
        posterior_variance=_f32(post_var, device),
        posterior_log_variance_clipped=_f32(post_log_var, device),
    )


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] as (B, 1, 1, ...) for broadcasting over an ndim-dim tensor."""
    vals = table[t]
    return vals.reshape(vals.shape[0], *([1] * (ndim - 1)))


def q_sample(sched: DDPMSchedule, x_start, t, noise):
    """Forward noising x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, the noise
    given explicitly."""
    a = _bcast(sched.sqrt_alphas_cumprod, t, x_start.ndim)
    s = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
    return a * x_start + s * noise


def predict_start_from_noise(sched: DDPMSchedule, x_noisy, eps, t):
    """x0 = sqrt(1/abar) x_t - sqrt(1/abar - 1) eps."""
    ra = _bcast(sched.sqrt_recip_alphas_cumprod, t, x_noisy.ndim)
    rm = _bcast(sched.sqrt_recipm1_alphas_cumprod, t, x_noisy.ndim)
    return ra * x_noisy - rm * eps


class DDIMSchedule(NamedTuple):
    """DDIM sub-schedule tables, each (S,); the loop walks i = S-1 .. 0."""

    timesteps: torch.Tensor  # int64 (S,)
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int, method: str = "uniform") -> np.ndarray:
    """The DDIM timesteps with the SD +1 offset
    (ldm/modules/diffusionmodules/util.py:46-61): "uniform", strides of T//S
    from 0; "quad", linspace(0, sqrt(0.8 T), S)^2 truncated."""
    if method == "uniform":
        steps = np.arange(0, num_ddpm_steps, num_ddpm_steps // num_ddim_steps)
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization {method!r}")
    return steps + 1


def make_ddim_schedule(
    num_ddpm_steps: int = 1000,
    num_steps: int = 50,
    linear_start: float = 0.00085,
    linear_end: float = 0.0120,
    device="cpu",
    *,
    eta: float = 1.0,
    method: str = "uniform",
) -> DDIMSchedule:
    """DDIM tables (mvdfusion/sampler.py:25-39) in fp64, stored fp32:
    sigma = eta * sqrt((1 - abar_prev) / (1 - abar) * (1 - abar / abar_prev)),
    eta 1 the reference's sampler, 0 the deterministic one."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_ddpm_steps, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    ts = make_ddim_timesteps(num_steps, num_ddpm_steps, method)
    alphas = abar[ts]
    alphas_prev = np.concatenate([abar[0:1], abar[ts[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return DDIMSchedule(
        timesteps=torch.as_tensor(ts, dtype=torch.int64, device=device),
        alphas=_f32(alphas, device),
        alphas_prev=_f32(alphas_prev, device),
        sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas), device),
        sigmas=_f32(sigmas, device),
    )


def ddim_step(ddim: DDIMSchedule, x_t, noise_pred, index: int, z):
    """x_prev = sqrt(abar_prev) x0 + sqrt(1 - abar_prev - sigma^2) eps + sigma z,
    with no noise at index 0 or where z is None (eta 0, every sigma 0).
    Returns (x_prev, pred_x0)."""
    a_t = ddim.alphas[index]
    a_prev = ddim.alphas_prev[index]
    sigma_t = ddim.sigmas[index]
    pred_x0 = (x_t - ddim.sqrt_one_minus_alphas[index] * noise_pred) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=1e-7)) * noise_pred
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if index != 0 and z is not None:
        x_prev = x_prev + sigma_t * z
    return x_prev, pred_x0
