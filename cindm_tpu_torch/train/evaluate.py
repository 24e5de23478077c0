"""Periodic training evaluation: sample with the EMA model and score against
the test set.

Port of ``cindm_tpu/train/evaluate.py``: DDIM sampling conditioned on the
test batch (by q-sample inpainting of its first 4 steps when the model is
unconditioned), then trajectory MAE and RMSE. Runs under ``torch.no_grad()``,
so the denoiser takes its kernels without autograd.
"""

from __future__ import annotations

import torch

from ..core.schedules import DiffusionSchedule
from ..sampling.diffusion1d import Diffusion1DConfig
from ..sampling.sampler import Randn, ddim_sample_loop


@torch.no_grad()
def sampling_eval_1d(
    cfg: Diffusion1DConfig,
    sched: DiffusionSchedule,
    eps_model,
    test_batch: dict,
    randn: Randn,
    *,
    sample_steps: int = 250,
) -> dict:
    """MAE/RMSE of trajectories sampled for ``test_batch`` ({'x', 'cond'})."""
    x = test_batch["x"]  # [B, rollout, F]
    cond = test_batch.get("cond")
    B, R, F = x.shape
    if cfg.conditioned_steps == 0:
        # inpaint the first 4 ground-truth steps, as the reference eval does
        out = ddim_sample_loop(
            sched, eps_model, (B, R, F), randn,
            sampling_timesteps=sample_steps, cond=x[:, :4], objective=cfg.objective,
        )
        pred, target = out[:, 4:], x[:, 4:]
    else:
        k = cfg.conditioned_steps

        def cond_eps(z, t):
            return eps_model(torch.cat([cond, z], dim=1), t)[:, k:]

        out = ddim_sample_loop(
            sched, cond_eps, (B, R, F), randn,
            sampling_timesteps=sample_steps, objective=cfg.objective,
        )
        pred, target = out, x
    return {"sample_mae": float((pred - target).abs().mean()),
            "sample_rmse": float((pred - target).square().mean().sqrt())}


@torch.no_grad()
def prediction_mae_1d(eps_model_rollout, test_batch: dict) -> dict:
    """Forward-model prediction MAE: a deterministic surrogate's rollout from
    the test batch's cond (its first step if it has none) against the truth."""
    x = test_batch["x"]
    cond = test_batch.get("cond", x[:, :1])
    pred = eps_model_rollout(cond)
    n = min(pred.shape[1], x.shape[1])
    return {"pred_mae": float((pred[:, :n] - x[:, :n]).abs().mean())}
