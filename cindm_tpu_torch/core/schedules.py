"""Diffusion beta schedules and their precomputed DDPM buffers.

Port of ``cindm_tpu/core/schedules.py``: every derived quantity is computed
once in float64 with numpy and stored as a float32 tensor on the target
device inside a frozen ``DiffusionSchedule``; samplers only gather from it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

BetaScheduleName = Literal["linear", "cosine", "sigmoid"]


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 2e-2, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3.0, end: float = 3.0, tau: float = 1.0
) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start = 1.0 / (1.0 + np.exp(-start / tau))
    v_end = 1.0 / (1.0 + np.exp(-end / tau))
    alphas_cumprod = (-1.0 / (1.0 + np.exp(-((t * (end - start) + start) / tau))) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All DDPM buffers, each a float32 tensor of shape [T] on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    # recurrence ("time-travel") relaxation coefficients
    sqrt_alpha_ratio: torch.Tensor  # sqrt(acp / acp_prev)
    sqrt_one_minus_alpha_ratio: torch.Tensor  # sqrt(1 - acp / acp_prev)
    # universal-backward delta-x0 coefficient
    backward_delta_coef: torch.Tensor
    # guidance step size eta_t = beta_t / sqrt(acp_prev)
    guidance_eta: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(
    timesteps: int = 1000,
    beta_schedule: BetaScheduleName = "cosine",
    device: str | torch.device = "cuda",
) -> DiffusionSchedule:
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    betas = _SCHEDULES[beta_schedule](timesteps)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])

    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    snr = acp / (1.0 - acp)

    def f(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    return DiffusionSchedule(
        betas=f(betas),
        alphas_cumprod=f(acp),
        alphas_cumprod_prev=f(acp_prev),
        sqrt_alphas_cumprod=f(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f(posterior_variance),
        posterior_log_variance_clipped=f(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        snr=f(snr),
        sqrt_alpha_ratio=f(np.sqrt(acp / acp_prev)),
        sqrt_one_minus_alpha_ratio=f(np.sqrt(1.0 - acp / acp_prev)),
        backward_delta_coef=f(np.sqrt(acp) * betas / (np.sqrt(1.0 - betas) * (1.0 - acp))),
        guidance_eta=f(betas / np.sqrt(acp_prev)),
    )


def snr_loss_weight(schedule: DiffusionSchedule, objective: str = "pred_noise") -> torch.Tensor:
    """Per-timestep SNR loss weights [T]."""
    snr = schedule.snr
    if objective == "pred_noise":
        return torch.ones_like(snr)
    if objective == "pred_x0":
        return snr
    if objective == "pred_v":
        return snr / (snr + 1.0)
    raise ValueError(f"unknown objective {objective}")


def min_snr_loss_weight(
    schedule: DiffusionSchedule, objective: str = "pred_noise", gamma: float = 5.0
) -> torch.Tensor:
    """Min-SNR-gamma loss weights [T]: the SNR clipped at ``gamma``."""
    snr = schedule.snr
    clipped = torch.clamp(snr, max=gamma)
    if objective == "pred_noise":
        return clipped / snr
    if objective == "pred_x0":
        return clipped
    if objective == "pred_v":
        return clipped / (snr + 1.0)
    raise ValueError(f"unknown objective {objective}")
