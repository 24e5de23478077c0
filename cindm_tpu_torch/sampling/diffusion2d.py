"""2D airfoil diffusion: multi-boundary composition and guided sampling.

Port of ``cindm_tpu/sampling/diffusion2d.py``. The state keeps the JAX
package's layout, x = [B*nb, H, W, C] channel-last, with C = frames*3 + 3
(per frame vx, vy, p; then mask, offx, offy). ``eps_model(x, t)`` takes and
returns that layout; ``nhwc_model`` wraps an NCHW ``models.Unet2D`` with
one permute each way per call. Composition over boundaries shares the state
channels (all but the last 3) across the boundary axis, by mean or sum.

Guidance takes ``design_fn(x) -> gradient`` (``guidance2d.make_design_grad_fn``).
The loops are Python loops under ``torch.no_grad()``; only ``design_fn``
takes a gradient. Draws come through ``randn(shape)`` (``sampler.Randn``)
in the order the JAX code splits its keys: ``sample_noise`` draws the
state noise [B, 1, H, W, C-3] (broadcast over the boundaries) and then the
boundary noise [B, nb, H, W, 3].

``p_losses_2d`` is the training loss over the same layout; its draws (t,
then the noise, then the cond noise) come from a ``torch.Generator`` unless
the caller passes them, as the parity tests do.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Callable, Optional

import torch

from ..core import diffusion as dd
from ..core.schedules import DiffusionSchedule, make_schedule, min_snr_loss_weight, snr_loss_weight
from .sampler import Randn

# design_fn returns the gradient of the design objective w.r.t. x
DesignGradFn = Callable[[torch.Tensor], torch.Tensor]
EpsModel2D = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Diffusion2DConfig:
    """The 2D ``GaussianDiffusion`` settings."""

    image_size: int = 64
    frames: int = 6
    cond_frames: int = 2
    pred_frames: int = 4
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    loss_type: str = "l2"
    objective: str = "pred_noise"
    beta_schedule: str = "sigmoid"
    ddim_sampling_eta: float = 0.0
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    diffuse_cond: bool = True
    backward_steps: int = 5
    backward_lr: float = 0.01
    standard_fixed_ratio: float = 0.01
    forward_fixed_ratio: float = 0.01
    coeff_ratio: float = 0.1
    share_noise: bool = True
    use_average_share: bool = True

    @property
    def channels(self) -> int:
        return self.frames * 3 + 3

    def make_schedule(self, device: str | torch.device = "cuda") -> DiffusionSchedule:
        return make_schedule(self.timesteps, self.beta_schedule, device=device)


def nhwc_model(model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> EpsModel2D:
    """An eps-model over [N, H, W, C] from one over [N, C, H, W]."""
    return lambda x, t: model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)


def share_states_over_boundaries(x: torch.Tensor, num_boundaries: int,
                                 use_average_share: bool = True) -> torch.Tensor:
    """Share the state channels (all but the last 3) across the boundaries.
    x: [B*nb, H, W, C]."""
    Bnb, H, W, C = x.shape
    xb = x.reshape(Bnb // num_boundaries, num_boundaries, H, W, C)
    states, boundary = xb[..., : C - 3], xb[..., C - 3:]
    agg = states.mean(dim=1, keepdim=True) if use_average_share else states.sum(dim=1, keepdim=True)
    return torch.cat([agg.expand_as(states), boundary], dim=-1).reshape(Bnb, H, W, C)


def sample_noise(randn: Randn, batch: int, num_boundaries: int, H: int, W: int, C: int) -> torch.Tensor:
    """Noise whose state channels are shared across the boundaries:
    [B*nb, H, W, C]."""
    state = randn((batch, 1, H, W, C - 3)).expand(batch, num_boundaries, H, W, C - 3)
    boundary = randn((batch, num_boundaries, H, W, 3))
    return torch.cat([state, boundary], dim=-1).reshape(batch * num_boundaries, H, W, C)


def asynchronous_clamp(x: torch.Tensor) -> torch.Tensor:
    """States to [-1, 1], mask to [0, 1], offsets to [-0.5, 0.5]."""
    C = x.shape[-1]
    return torch.cat([x[..., : C - 3].clamp(-1.0, 1.0), x[..., C - 3: C - 2].clamp(0.0, 1.0),
                      x[..., C - 2:].clamp(-0.5, 0.5)], dim=-1)


def _model_predictions(cfg: Diffusion2DConfig, sched: DiffusionSchedule, eps_model: EpsModel2D,
                       x: torch.Tensor, t_b: torch.Tensor, num_boundaries: int,
                       clip_denoised: bool = True):
    """p_mean_variance with boundary sharing: (mean, log variance, x_start)."""
    out = eps_model(x, t_b)
    if cfg.share_noise:
        out = share_states_over_boundaries(out, num_boundaries, cfg.use_average_share)
    pred = dd.model_prediction_from_output(sched, out, x, t_b, cfg.objective)
    x_start = pred.pred_x_start.clamp(-1.0, 1.0) if clip_denoised else pred.pred_x_start
    if not cfg.share_noise:
        x_start = share_states_over_boundaries(x_start, num_boundaries, cfg.use_average_share)
    post = dd.q_posterior(sched, x_start, x, t_b)
    mean = post.mean
    if not cfg.share_noise:
        mean = share_states_over_boundaries(mean, num_boundaries, cfg.use_average_share)
    return mean, post.log_variance_clipped, x_start


def _parse_guidance(design_guidance: str) -> tuple[str, int]:
    m = re.match(r"^(.*?)(?:-recurrence-(\d+))?$", design_guidance)
    return m.group(1), int(m.group(2) or 0)


def p_sample_2d(cfg: Diffusion2DConfig, sched: DiffusionSchedule, eps_model: EpsModel2D,
                x: torch.Tensor, t: int, randn: Randn, *, batch: int, num_boundaries: int,
                design_fn: Optional[DesignGradFn] = None,
                design_guidance: str = "standard-alpha") -> tuple[torch.Tensor, torch.Tensor]:
    """One guided reverse step at timestep ``t``: (x_{t-1}, x_start).

    Without recurrence the step noise is added first and the guidance
    subtracted after. "...-recurrence-K" relaxes back to level t K times,
    each pass with fresh state-shared noise. The step noise is drawn at
    t = 0 too, and zeroed."""
    Bnb, H, W, C = x.shape
    t_b = torch.full((Bnb,), t, dtype=torch.long, device=x.device)
    base, rec = _parse_guidance(design_guidance)

    def guidance_grad(xc, x_start):
        if base == "standard":
            return cfg.standard_fixed_ratio * design_fn(xc)
        if base == "standard-alpha":
            return (cfg.coeff_ratio * sched.betas.flip(0)[t]) * design_fn(xc)
        if base == "universal-forward":
            return cfg.forward_fixed_ratio * design_fn(x_start)
        if base == "universal-backward":
            xb, snap = x_start, torch.zeros_like(x_start)
            for kk in range(cfg.backward_steps):
                gr = design_fn(xb)
                if kk == 1:
                    snap = cfg.forward_fixed_ratio * gr
                xb = xb - gr * cfg.backward_lr
            return snap - dd.extract(sched.backward_delta_coef, t_b, x.ndim) * (xb - x_start)
        raise ValueError(f"unknown design_guidance {design_guidance}")

    def step_noise():
        noise = sample_noise(randn, batch, num_boundaries, H, W, C)
        return noise if t > 0 else torch.zeros_like(noise)

    if rec == 0 or design_fn is None:
        mean, logvar, x_start = _model_predictions(cfg, sched, eps_model, x, t_b, num_boundaries)
        pred_img = mean + torch.exp(0.5 * logvar) * step_noise()
        if design_fn is not None:
            pred_img = pred_img - guidance_grad(x, x_start)
        return pred_img, x_start

    x_cur = x
    for _ in range(rec):
        mean, logvar, x_start = _model_predictions(cfg, sched, eps_model, x_cur, t_b, num_boundaries)
        pred_img = mean - guidance_grad(x_cur, x_start)
        noise_prime = sample_noise(randn, batch, num_boundaries, H, W, C)
        x_cur = (dd.extract(sched.sqrt_alpha_ratio, t_b, x.ndim) * pred_img
                 + dd.extract(sched.sqrt_one_minus_alpha_ratio, t_b, x.ndim) * noise_prime)
    logvar = dd.extract(sched.posterior_log_variance_clipped, t_b, x.ndim)
    return pred_img + torch.exp(0.5 * logvar) * step_noise(), x_start


def p_sample_loop_2d(cfg: Diffusion2DConfig, sched: DiffusionSchedule, eps_model: EpsModel2D,
                     randn: Randn, *, batch: int, num_boundaries: int,
                     design_fn: Optional[DesignGradFn] = None,
                     design_guidance: str = "standard-alpha", host_chunks: int = 1,
                     init_bias: Optional[torch.Tensor] = None,
                     station_pattern: Optional[torch.Tensor] = None, station_until: int = 0,
                     region_mask: Optional[torch.Tensor] = None,
                     progress: bool = False) -> torch.Tensor:
    """The full ancestral loop; returns [B, nb, H, W, C].

    ``init_bias`` is added to x_T. ``station_pattern`` ([B*nb, H, W], data
    units) q-sample-inpaints the mask channel toward the pattern while
    t >= ``station_until``. ``region_mask`` ([B*nb, H, W], binary) inpaints
    the mask channel to noised zero outside each boundary's region at every
    step, exactly zero at t = 0. Both inpaintings use one draw per step,
    made after the step's own draws whenever either is given.
    ``host_chunks`` only sets how often ``progress`` prints a line to
    stderr (the JAX flag splits the loop into device launches)."""
    H = W = cfg.image_size
    C = cfg.channels
    img = sample_noise(randn, batch, num_boundaries, H, W, C)
    if init_bias is not None:
        img = img + init_bias
    chunk = max(cfg.timesteps // max(host_chunks, 1), 1)
    with torch.no_grad():
        for i, t in enumerate(range(cfg.timesteps - 1, -1, -1)):
            img, _ = p_sample_2d(cfg, sched, eps_model, img, t, randn, batch=batch,
                                 num_boundaries=num_boundaries, design_fn=design_fn,
                                 design_guidance=design_guidance)
            if station_pattern is not None or region_mask is not None:
                shape = (station_pattern if station_pattern is not None else region_mask).shape
                k2 = randn(tuple(shape))
                t_b = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
            if station_pattern is not None and t >= station_until:
                noisy = dd.q_sample(sched, station_pattern, t_b, k2)
                img = torch.cat([img[..., : C - 3], noisy[..., None], img[..., C - 2:]], dim=-1)
            if region_mask is not None:
                zero_noisy = dd.q_sample(sched, torch.zeros_like(region_mask), t_b, k2)
                if t == 0:
                    zero_noisy = torch.zeros_like(zero_noisy)
                cur = img[..., C - 3]
                constrained = region_mask * cur + (1.0 - region_mask) * zero_noisy
                img = torch.cat([img[..., : C - 3], constrained[..., None], img[..., C - 2:]], dim=-1)
            if progress and host_chunks > 1 and (i + 1) % chunk == 0:
                print(f"[sample2d] chunk {(i + 1) // chunk}/{host_chunks}", file=sys.stderr,
                      flush=True)
    return img.reshape(batch, num_boundaries, H, W, C)


def ddim_sample_loop_2d(cfg: Diffusion2DConfig, sched: DiffusionSchedule, eps_model: EpsModel2D,
                        randn: Randn, *, batch: int, num_boundaries: int, sampling_timesteps: int,
                        design_fn: Optional[DesignGradFn] = None,
                        design_guidance: str = "standard-alpha",
                        init_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Guided DDIM over ``sampling_timesteps`` steps; the guidance shifts x0
    with the same coefficient schedules. Returns [B, nb, H, W, C]."""
    H = W = cfg.image_size
    C = cfg.channels
    times, times_next = dd.ddim_times(cfg.timesteps, sampling_timesteps)
    img = sample_noise(randn, batch, num_boundaries, H, W, C)
    if init_bias is not None:
        img = img + init_bias
    Bnb = batch * num_boundaries
    coeff_sched = cfg.coeff_ratio * sched.betas.flip(0)
    one = torch.ones((), device=img.device)
    with torch.no_grad():
        for t, t_next in zip(times, times_next):
            t_b = torch.full((Bnb,), t, dtype=torch.long, device=img.device)
            out = eps_model(img, t_b)
            if cfg.share_noise:
                out = share_states_over_boundaries(out, num_boundaries, cfg.use_average_share)
            pred = dd.model_prediction_from_output(sched, out, img, t_b, cfg.objective,
                                                   clip_x_start=True, rederive_pred_noise=True)
            pred_noise, x_start = pred.pred_noise, pred.pred_x_start
            if design_fn is not None:
                ratio = cfg.standard_fixed_ratio if design_guidance == "standard" else coeff_sched[t]
                x_start = (x_start - ratio * design_fn(img)).clamp(-1.0, 1.0)
                pred_noise = dd.predict_noise_from_start(sched, img, t_b, x_start)
            alpha = sched.alphas_cumprod[t]
            alpha_next = sched.alphas_cumprod[t_next] if t_next >= 0 else one
            sigma = cfg.ddim_sampling_eta * torch.sqrt(
                (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt((1 - alpha_next - sigma ** 2).clamp(min=0.0))
            noise = sample_noise(randn, batch, num_boundaries, H, W, C)
            img = (x_start if t_next < 0
                   else x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * noise)
    return img.reshape(batch, num_boundaries, H, W, C)


def p_losses_2d(
    cfg: Diffusion2DConfig,
    sched: DiffusionSchedule,
    eps_model: EpsModel2D,
    x_start: torch.Tensor,  # [B, H, W, pred_frames*3 + 3]
    cond: torch.Tensor,  # [B, H, W, cond_frames*3]
    *,
    t: Optional[torch.Tensor] = None,  # [B] timesteps
    noise: Optional[torch.Tensor] = None,  # like x_start
    noise_cond: Optional[torch.Tensor] = None,  # like cond
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Training loss. With ``diffuse_cond`` both the cond and the pred parts
    are diffused and the target is the concatenated noise; else the clean
    cond is concatenated and only the pred part of the output is scored.
    Per-timestep SNR (or min-SNR) weights. Draws t ~ U[0, T), then the
    noise, then (with ``diffuse_cond``) the cond noise, from ``generator``,
    unless they are given."""
    B = x_start.shape[0]
    dev = x_start.device
    if t is None:
        t = torch.randint(0, cfg.timesteps, (B,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev, dtype=x_start.dtype)
    x = dd.q_sample(sched, x_start, t, noise)
    if cfg.diffuse_cond:
        if noise_cond is None:
            noise_cond = torch.randn(cond.shape, generator=generator, device=dev, dtype=cond.dtype)
        cond_t = dd.q_sample(sched, cond, t, noise_cond)
        target = torch.cat([noise_cond, noise], dim=-1)
    else:
        cond_t = cond
        target = noise
    out = eps_model(torch.cat([cond_t, x], dim=-1), t)
    if not cfg.diffuse_cond:
        out = out[..., cond.shape[-1]:]
    if cfg.objective == "pred_x0":
        target = x_start
    elif cfg.objective == "pred_v":
        target = dd.predict_v(sched, x_start, t, noise)
    elif cfg.objective != "pred_noise":
        raise ValueError(cfg.objective)
    if cfg.loss_type == "l1":
        loss = (out - target).abs()
    elif cfg.loss_type == "l2":
        loss = (out - target).square()
    else:
        raise ValueError(cfg.loss_type)
    loss = loss.reshape(B, -1).mean(dim=-1)
    lw = (min_snr_loss_weight(sched, cfg.objective, cfg.min_snr_gamma) if cfg.min_snr_loss_weight
          else snr_loss_weight(sched, cfg.objective))
    return (loss * lw[t]).mean()
