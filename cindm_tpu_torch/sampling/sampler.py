"""Guided reverse-diffusion samplers.

Port of ``cindm_tpu/sampling/sampler.py``. The JAX package's ``lax.scan``
loops become Python loops. Guidance variants follow "Universal Guidance for
Diffusion Models": standard, standard-alpha, universal-forward and
universal-backward, each optionally with "-recurrence-K" self-recurrence.

Guidance differentiates only the design objective, never the denoiser: the
denoiser runs under ``torch.no_grad()`` and the gradient is
``torch.autograd.grad`` of ``design_fn``. The step functions take their noise
as tensors; the loops draw it through ``randn(shape)``, by default from a
``torch.Generator``, in the order the JAX loops split their keys: x_T first,
then per step the recurrence draws, the step noise and the cond noise.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Literal, Optional, Sequence

import torch

from ..core import diffusion as dd
from ..core.schedules import DiffusionSchedule
from .compose import EpsModel

DesignFn = Callable[[torch.Tensor], torch.Tensor]  # x -> scalar objective
Randn = Callable[[tuple[int, ...]], torch.Tensor]  # shape -> standard normal draw


def generator_randn(generator: torch.Generator, device: torch.device) -> Randn:
    """Standard normal draws from ``generator`` on ``device``."""
    return lambda shape: torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """Parsed design_guidance string."""

    base: Literal["standard", "standard-alpha", "universal-forward", "universal-backward"]
    recurrence: int = 0  # 0 = no recurrence loop; K = "-recurrence-K"
    backward_steps: int = 5
    backward_lr: float = 1.0

    @staticmethod
    def parse(s: str, backward_steps: int = 5, backward_lr: float = 1.0) -> "GuidanceSpec":
        m = re.match(r"^(standard-alpha|standard|universal-forward|universal-backward)"
                     r"(?:-recurrence-(\d+))?$", s)
        if not m:
            raise ValueError(f"unknown design_guidance {s!r}")
        rec = int(m.group(2)) if m.group(2) else 0
        return GuidanceSpec(m.group(1), rec, backward_steps, backward_lr)


def _grad(design_fn: DesignFn, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        return torch.autograd.grad(design_fn(xg), xg)[0]


def _guidance_grad(
    sched: DiffusionSchedule,
    spec: GuidanceSpec,
    design_fn: DesignFn,
    x: torch.Tensor,
    x_start: torch.Tensor,
    t_b: torch.Tensor,
) -> torch.Tensor:
    """The design gradient subtracted from the posterior mean at one step."""
    nd = x.ndim
    eta = dd.extract(sched.guidance_eta, t_b, nd)
    if spec.base == "standard":
        return _grad(design_fn, x)
    if spec.base == "standard-alpha":
        return eta * _grad(design_fn, x)
    if spec.base == "universal-forward":
        return eta * _grad(design_fn, x_start)
    if spec.base == "universal-backward":
        # inner GD steps on x0; the grad at step 1 scaled by eta; then the
        # delta-x0 correction
        if spec.backward_steps < 2:
            raise ValueError("universal-backward needs backward_steps >= 2")
        xc, snap = x_start, torch.zeros_like(x_start)
        for kk in range(spec.backward_steps):
            g = _grad(design_fn, xc)
            if kk == 1:
                snap = eta * g
            xc = xc - g * spec.backward_lr
        return snap - dd.extract(sched.backward_delta_coef, t_b, nd) * (xc - x_start)
    raise ValueError(spec.base)


def _p_mean_variance(sched, eps_model, x, t_b, objective="pred_noise", clip_denoised=True):
    with torch.no_grad():
        out = eps_model(x, t_b)
    pred = dd.model_prediction_from_output(sched, out, x, t_b, objective)
    x_start = pred.pred_x_start.clamp(-1.0, 1.0) if clip_denoised else pred.pred_x_start
    post = dd.q_posterior(sched, x_start, x, t_b)
    return post.mean, post.log_variance_clipped, x_start


def _overwrite_initial(pred_img: torch.Tensor, initial_state_overwrite: Optional[torch.Tensor]):
    """Clamp the first steps to a fixed state."""
    if initial_state_overwrite is None:
        return pred_img
    k = initial_state_overwrite.shape[1]
    return torch.cat([initial_state_overwrite, pred_img[:, k:]], dim=1)


def p_sample_step(
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    x: torch.Tensor,
    t: int,
    noise: torch.Tensor,
    noise_primes: Sequence[torch.Tensor] = (),
    *,
    design_fn: Optional[DesignFn] = None,
    guidance: Optional[GuidanceSpec] = None,
    initial_state_overwrite: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
    objective: str = "pred_noise",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One guided ancestral reverse step. Returns (x_{t-1}, x0_hat).

    ``noise`` is the step noise (ignored at t == 0); ``noise_primes`` holds
    one draw per recurrence iteration when guidance has recurrence.
    """
    B = x.shape[0]
    t_b = torch.full((B,), t, dtype=torch.long, device=x.device)

    def one_pass(x):
        mean, logvar, x_start = _p_mean_variance(sched, eps_model, x, t_b, objective, clip_denoised)
        pred_img = mean
        if design_fn is not None:
            pred_img = mean - _guidance_grad(sched, guidance, design_fn, x, x_start, t_b)
        return _overwrite_initial(pred_img, initial_state_overwrite), logvar, x_start

    rec = guidance.recurrence if (guidance is not None and design_fn is not None) else 0
    if len(noise_primes) != rec:
        raise ValueError(f"expected {rec} recurrence noise draws, got {len(noise_primes)}")
    if rec == 0:
        pred_img, logvar, x_start = one_pass(x)
    else:
        # self-recurrence: re-noise pred_img back to level t each iteration
        nd = x.ndim
        a = dd.extract(sched.sqrt_alpha_ratio, t_b, nd)
        b = dd.extract(sched.sqrt_one_minus_alpha_ratio, t_b, nd)
        x_cur = x
        for noise_prime in noise_primes:
            pred_img, _, x_start = one_pass(x_cur)
            x_cur = a * pred_img + b * noise_prime
        logvar = dd.extract(sched.posterior_log_variance_clipped, t_b, nd)
    if t == 0:
        noise = torch.zeros_like(noise)
    return pred_img + torch.exp(0.5 * logvar) * noise, x_start


def p_sample_loop(
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    shape: tuple[int, ...],
    randn: Randn,
    *,
    cond: Optional[torch.Tensor] = None,
    design_fn: Optional[DesignFn] = None,
    guidance: Optional[GuidanceSpec] = None,
    initial_state_overwrite: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
    objective: str = "pred_noise",
    init_img: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full T -> 0 ancestral loop.

    ``cond`` is inpainted into the first steps by re-noising it to level t
    after every step.
    """
    img = randn(shape) if init_img is None else init_img
    rec = guidance.recurrence if (guidance is not None and design_fn is not None) else 0
    for t in range(sched.num_timesteps - 1, -1, -1):
        noise_primes = [randn(shape) for _ in range(rec)]
        img, _ = p_sample_step(
            sched, eps_model, img, t, randn(shape), noise_primes,
            design_fn=design_fn, guidance=guidance,
            initial_state_overwrite=initial_state_overwrite,
            clip_denoised=clip_denoised, objective=objective,
        )
        if cond is not None:
            t_b = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
            noisy_cond = dd.q_sample(sched, cond, t_b, randn(tuple(cond.shape)))
            img = torch.cat([noisy_cond, img[:, cond.shape[1]:]], dim=1)
    return img


def ddim_sample_loop(
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    shape: tuple[int, ...],
    randn: Randn,
    *,
    sampling_timesteps: int,
    eta: float = 0.0,
    cond: Optional[torch.Tensor] = None,
    design_fn: Optional[DesignFn] = None,
    guidance: Optional[GuidanceSpec] = None,
    initial_state_overwrite: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
    objective: str = "pred_noise",
    init_img: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampler; guidance shifts x0_hat by the design gradient before the update."""
    times, times_next = dd.ddim_times(sched.num_timesteps, sampling_timesteps)
    img = randn(shape) if init_img is None else init_img
    B = shape[0]
    for t, t_next in zip(times, times_next):
        t_b = torch.full((B,), t, dtype=torch.long, device=img.device)
        with torch.no_grad():
            out = eps_model(img, t_b)
        pred = dd.model_prediction_from_output(
            sched, out, img, t_b, objective, clip_x_start=clip_denoised
        )
        pred_noise, x_start = pred.pred_noise, pred.pred_x_start
        if design_fn is not None:
            x_start = x_start - _guidance_grad(sched, guidance, design_fn, img, x_start, t_b)
            x_start = _overwrite_initial(x_start, initial_state_overwrite)
            pred_noise = dd.predict_noise_from_start(sched, img, t_b, x_start)
        alpha = sched.alphas_cumprod[t]
        alpha_next = sched.alphas_cumprod[t_next] if t_next >= 0 else torch.ones_like(alpha)
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0))
        noise = randn(shape)
        if t_next < 0:
            img = x_start  # final step returns x0_hat
        else:
            img = x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * noise
        if cond is not None:
            noisy_cond = dd.q_sample(sched, cond, t_b, randn(tuple(cond.shape)))
            inpaint = cond if t_next < 0 else noisy_cond
            img = torch.cat([inpaint, img[:, cond.shape[1]:]], dim=1)
    return img
