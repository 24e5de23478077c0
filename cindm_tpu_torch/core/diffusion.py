"""DDPM math over trajectory tensors.

Port of ``cindm_tpu/core/diffusion.py``: plain functions of a
``DiffusionSchedule`` and tensors. ``t`` arguments are integer tensors of
shape [B] (one timestep per batch row); buffer gathers broadcast against the
trailing dims.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import numpy as np
import torch

from .schedules import DiffusionSchedule

Objective = Literal["pred_noise", "pred_x0", "pred_v"]


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather buf[t] ([B]) and reshape to [B, 1, ..., 1] with `ndim` dims total."""
    out = buf[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(
    sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Forward process q(x_t | x_0)."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_start_from_noise(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def predict_noise_from_start(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, x0: torch.Tensor
) -> torch.Tensor:
    nd = x_t.ndim
    return (extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0) / extract(
        sched.sqrt_recipm1_alphas_cumprod, t, nd
    )


def predict_v(
    sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * noise
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
    )


def predict_start_from_v(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    nd = x_t.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


class Posterior(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance_clipped: torch.Tensor


def q_posterior(
    sched: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor
) -> Posterior:
    """q(x_{t-1} | x_t, x_0)."""
    nd = x_t.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    return Posterior(
        mean=mean,
        variance=extract(sched.posterior_variance, t, nd),
        log_variance_clipped=extract(sched.posterior_log_variance_clipped, t, nd),
    )


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def model_prediction_from_output(
    sched: DiffusionSchedule,
    model_output: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    objective: Objective = "pred_noise",
    clip_x_start: bool = False,
    rederive_pred_noise: bool = False,
) -> ModelPrediction:
    """Convert raw denoiser output to (eps_hat, x0_hat)."""
    clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
    if objective == "pred_noise":
        pred_noise = model_output
        x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
        if clip_x_start and rederive_pred_noise:
            pred_noise = predict_noise_from_start(sched, x, t, x_start)
    elif objective == "pred_x0":
        x_start = clip(model_output)
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    elif objective == "pred_v":
        x_start = clip(predict_start_from_v(sched, x, t, model_output))
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    else:
        raise ValueError(f"unknown objective {objective}")
    return ModelPrediction(pred_noise, x_start)


def ddim_times(num_timesteps: int, sampling_timesteps: int) -> tuple[list[int], list[int]]:
    """DDIM time pairs (t, t_next), t descending, as Python ints."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1).astype(np.int32)
    times = times[::-1]
    return [int(v) for v in times[:-1]], [int(v) for v in times[1:]]
