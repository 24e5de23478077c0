"""Trajectory diffusion config, the training loss and the sampling dispatcher.

Port of ``cindm_tpu/sampling/diffusion1d.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import diffusion as dd
from ..core.schedules import DiffusionSchedule, make_schedule
from .compose import EpsModel, make_composed_eps_model
from .sampler import GuidanceSpec, Randn, ddim_sample_loop, p_sample_loop


@dataclasses.dataclass(frozen=True)
class Diffusion1DConfig:
    """Mirrors the JAX package's ``Diffusion1DConfig``."""

    rollout_steps: int  # image_size
    conditioned_steps: int = 0
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    loss_type: str = "l1"
    objective: str = "pred_noise"
    beta_schedule: str = "cosine"
    ddim_sampling_eta: float = 0.0
    loss_weight_discount: float = 0.95
    backward_steps: int = 5
    backward_lr: float = 1.0

    @property
    def horizon(self) -> int:
        return self.conditioned_steps + self.rollout_steps

    def make_schedule(self, device: str | torch.device = "cuda") -> DiffusionSchedule:
        return make_schedule(self.timesteps, self.beta_schedule, device=device)


def p_losses(
    cfg: Diffusion1DConfig,
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    x_start: torch.Tensor,  # [B, rollout_steps, F]
    cond: Optional[torch.Tensor],  # [B, conditioned_steps, F] or None
    *,
    t: Optional[torch.Tensor] = None,  # [B] timesteps
    noise: Optional[torch.Tensor] = None,  # like x_start
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Training loss.

    Draws t ~ U[0, T) and standard normal noise (from ``generator``) unless
    they are given, diffuses the rollout part, concatenates the clean cond on
    the time axis, predicts noise over the full horizon with a zero-noise
    target on the cond steps, and applies the discounted per-step weights.
    """
    B, R, F = x_start.shape
    dev = x_start.device
    if t is None:
        t = torch.randint(0, cfg.timesteps, (B,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev, dtype=x_start.dtype)
    x = dd.q_sample(sched, x_start, t, noise)
    x_start_full = x_start
    if cfg.conditioned_steps != 0:
        if cond is None or cond.shape[1] != cfg.conditioned_steps:
            raise ValueError(f"p_losses: cond must have {cfg.conditioned_steps} steps")
        x = torch.cat([cond, x], dim=1)
        target_noise = torch.cat([torch.zeros_like(cond), noise], dim=1)
        # pred_x0 / pred_v targets span the full horizon: the clean cond is
        # the x0 target on the cond steps, matching the zero-noise target
        x_start_full = torch.cat([cond, x_start], dim=1)
    else:
        target_noise = noise
    model_out = eps_model(x, t)
    if cfg.loss_type == "loss_type3":
        from ..utils.extras import custom_l1_speed_loss

        return custom_l1_speed_loss(model_out, target_noise)
    weight = dd.rollout_loss_weight(cfg.conditioned_steps, R, F, cfg.loss_weight_discount, dev)
    return dd.diffusion_loss(
        sched, model_out, x_start_full, target_noise, t,
        objective=cfg.objective, loss_type=cfg.loss_type, loss_weight=weight,
    )


def sample_total_steps(
    cfg: Diffusion1DConfig,
    n_composed: int = 0,
    compose_start_step: int = 4,
    compose_n_bodies: int = 2,
) -> int:
    """Time length of the array ``sample`` denoises."""
    if n_composed > 0 or compose_n_bodies > 2:
        return cfg.horizon + n_composed * compose_start_step
    if cfg.conditioned_steps > 0:
        return cfg.rollout_steps
    return cfg.horizon


def sample(
    cfg: Diffusion1DConfig,
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    randn: Randn,
    batch_size: int,
    feature_size: int,
    *,
    cond: Optional[torch.Tensor] = None,
    design_fn=None,
    design_guidance: str = "standard",
    n_composed: int = 0,
    compose_start_step: int = 4,
    compose_n_bodies: int = 2,
    compose_mode: str = "mean-inside",
    initial_state_overwrite: Optional[torch.Tensor] = None,
    sample_steps: Optional[int] = None,
    init_img: Optional[torch.Tensor] = None,
    fold_chunks: int = 1,
) -> torch.Tensor:
    """DDIM when sample_steps < T, else full ancestral; composed eps-model
    when there is something to compose (extra windows or > 2 bodies)."""
    steps = sample_steps or cfg.sampling_timesteps or cfg.timesteps
    cond_for_loop = cond
    if n_composed > 0 or compose_n_bodies > 2:
        # "mean"/"noise_sum" = outside composition: per-pair x0 clipping
        # before aggregation
        outside = "inside" not in compose_mode
        model = make_composed_eps_model(
            eps_model,
            compose_n_bodies=compose_n_bodies,
            n_composed=n_composed,
            compose_start_step=compose_start_step,
            single_model_step=cfg.horizon,
            compose_mode="sum-inside" if compose_mode == "noise_sum"
            else ("mean-inside" if outside else compose_mode),
            sched=sched,
            clip_pairwise_x_start=outside,
            fold_chunks=fold_chunks,
        )
    elif cfg.conditioned_steps > 0:
        # conditioned model: the clean cond is concatenated into the denoiser
        # input and only the rollout part is diffused
        if cond is None:
            raise ValueError("conditioned model needs cond at sampling")
        base, c, k = eps_model, cond, cfg.conditioned_steps

        def model(z, t):
            return base(torch.cat([c, z], dim=1), t)[:, k:]

        cond_for_loop = None
    else:
        model = eps_model
    total_steps = sample_total_steps(cfg, n_composed, compose_start_step, compose_n_bodies)
    shape = (batch_size, total_steps, feature_size)
    guidance = GuidanceSpec.parse(design_guidance, cfg.backward_steps, cfg.backward_lr)

    if steps < cfg.timesteps:
        return ddim_sample_loop(
            sched, model, shape, randn,
            sampling_timesteps=steps, eta=cfg.ddim_sampling_eta,
            cond=cond_for_loop, design_fn=design_fn, guidance=guidance,
            initial_state_overwrite=initial_state_overwrite,
            objective=cfg.objective, init_img=init_img,
        )
    return p_sample_loop(
        sched, model, shape, randn,
        cond=cond_for_loop, design_fn=design_fn, guidance=guidance,
        initial_state_overwrite=initial_state_overwrite,
        objective=cfg.objective, init_img=init_img,
    )
