"""Time-composition and energy-based multi-body samplers.

Port of ``cindm_tpu/sampling/compose_time.py``:

- ``composing_time_sample``: (n_composed + 1) chained windows denoised in
  parallel under one DDIM loop, the window axis folded into the batch (one
  denoiser forward a step); before every forward, window i+1's condition is
  refreshed from the last ``conditioned_steps`` frames of window i's
  current sample;
- ``autoregress_time_compose_sample``: one full DDIM per window, each
  conditioned on the previous window's result;
- ``make_classifier_free_compose_eps``: eps_i = sum over pairs holding i of
  eps_pair - c * eps_uncond(i), for any number of bodies, as one batched
  pair forward and one batched 1-body forward;
- ``sample_compose_multibodies``: Langevin (ULA) steps with that composed
  score above ``t_switch``, ancestral steps below;
- ``sample_compose_multibodies_uhmc``: the underdamped-HMC variant.

The JAX package's scans, fori_loops and conds are Python loops and
branches. Draws come through ``randn(shape)`` in the order the JAX
functions split their keys; a draw the JAX code makes and never uses (the
DDIM noise of ``composing_time_sample``) is not made.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import diffusion as dd
from ..core.schedules import DiffusionSchedule
from .compose import EpsModel, pair_indices
from .sampler import Randn, ddim_sample_loop, p_sample_step


def composing_time_sample(
    sched: DiffusionSchedule,
    eps_model: EpsModel,  # conditioned model over [B, cond + rollout, F]
    batch: int,
    rollout_steps: int,
    conditioned_steps: int,
    feature_size: int,
    cond: torch.Tensor,  # [B, conditioned_steps, F]: window 0's condition
    randn: Randn,
    *,
    n_composed: int = 2,
    sampling_timesteps: int = 250,
    clip_denoised: bool = True,
    objective: str = "pred_noise",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel chained-window DDIM (eta 0). Each continuation window lies
    wholly after the previous one. Draws: x_T for all windows, then the
    windows' initial conditions (window 0's is replaced by ``cond``).

    Returns (window 0 [B, rollout, F], the continuation stitched
    [B, n_composed * rollout, F])."""
    K = n_composed + 1
    times, times_next = dd.ddim_times(sched.num_timesteps, sampling_timesteps)
    img = randn((K * batch, rollout_steps, feature_size))
    cond_all = randn((K * batch, conditioned_steps, feature_size))
    cond_all[:batch] = cond
    cs = conditioned_steps
    for t, t_next in zip(times, times_next):
        for i in range(n_composed):
            cond_all[(i + 1) * batch:(i + 2) * batch] = img[i * batch:(i + 1) * batch, -cs:]
        t_b = torch.full((K * batch,), t, dtype=torch.long, device=img.device)
        x_full = torch.cat([cond_all, img], dim=1)
        with torch.no_grad():
            out = eps_model(x_full, t_b)
        pred = dd.model_prediction_from_output(sched, out, x_full, t_b, objective,
                                               clip_x_start=clip_denoised)
        pred_noise, x_start = pred.pred_noise[:, cs:], pred.pred_x_start[:, cs:]
        if t_next < 0:
            img = x_start
        else:
            alpha_next = sched.alphas_cumprod[t_next]
            c = torch.sqrt(torch.clamp(1.0 - alpha_next, min=0.0))
            img = x_start * torch.sqrt(alpha_next) + c * pred_noise
    img0 = img[:batch]
    pieces = [img[(i + 1) * batch:(i + 2) * batch] for i in range(n_composed)]
    return img0, torch.cat(pieces, dim=1) if pieces else img0[:, :0]


def autoregress_time_compose_sample(
    sched: DiffusionSchedule,
    eps_model: EpsModel,
    batch: int,
    rollout_steps: int,
    conditioned_steps: int,
    feature_size: int,
    cond: torch.Tensor,
    randn: Randn,
    *,
    n_composed: int = 2,
    sampling_timesteps: int = 250,
    objective: str = "pred_noise",
) -> torch.Tensor:
    """Sequential window chaining: a full DDIM per window, each window's
    tail the next one's condition; [B, (n_composed + 1) * rollout, F]. The
    windows' draws follow one another through ``randn``."""
    outs, cur = [], cond
    for _ in range(n_composed + 1):
        def cond_eps(x, t, _c=cur):
            return eps_model(torch.cat([_c, x], dim=1), t)[:, conditioned_steps:]

        img = ddim_sample_loop(sched, cond_eps, (batch, rollout_steps, feature_size), randn,
                               sampling_timesteps=sampling_timesteps, objective=objective)
        outs.append(img)
        cur = img[:, -conditioned_steps:]
    return torch.cat(outs, dim=1)


def make_classifier_free_compose_eps(
    pair_model: EpsModel,  # 2-body model over [*, T, 2F]
    uncond_model: EpsModel,  # 1-body model over [*, T, F]
    n_bodies: int,
    *,
    coefficient: float = 1.4,
    feature_size: int = 4,
) -> EpsModel:
    """eps_i = sum over pairs holding body i of eps_pair - c * eps_uncond(i),
    for any ``n_bodies``: one pair forward over [P*B, T, 2F] and one 1-body
    forward over [n*B, T, F] per call."""
    pi, pj = pair_indices(n_bodies)
    P, F = len(pi), feature_size
    A = np.zeros((P, 2, n_bodies), dtype=np.float32)
    A[np.arange(P), 0, pi] = 1.0
    A[np.arange(P), 1, pj] = 1.0
    consts: dict = {}

    def eps(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if x.device not in consts:
            consts[x.device] = tuple(torch.as_tensor(a, device=x.device) for a in (A, pi, pj))
        A_t, pi_t, pj_t = consts[x.device]
        B, T, _ = x.shape
        xb = x.reshape(B, T, n_bodies, F)
        pair_in = torch.cat([xb[:, :, pi_t], xb[:, :, pj_t]], dim=-1)  # [B, T, P, 2F]
        pair_in = pair_in.permute(2, 0, 1, 3).reshape(P * B, T, 2 * F)
        e = pair_model(pair_in, t.repeat(P)).reshape(P, B, T, 2, F).permute(1, 2, 0, 3, 4)
        summed = torch.einsum("btpcf,pcn->btnf", e, A_t)  # sum over the pairs of each body
        singles = xb.permute(2, 0, 1, 3).reshape(n_bodies * B, T, F)
        eu = uncond_model(singles, t.repeat(n_bodies))
        eu = eu.reshape(n_bodies, B, T, F).permute(1, 2, 0, 3)
        return (summed - coefficient * eu).reshape(B, T, n_bodies * F)

    return eps


def _inpaint(sched, x, cond, conditioned_steps, t, t_b, randn):
    """Re-noise the clean cond frames to level t (clean at t = 0) and write
    them over the first ``conditioned_steps`` frames. Draws nothing when
    there are none."""
    if conditioned_steps == 0:
        return x
    noisy = dd.q_sample(sched, cond, t_b, randn(tuple(cond.shape)))
    return torch.cat([noisy if t > 0 else cond, x[:, conditioned_steps:]], dim=1)


def sample_compose_multibodies(
    sched: DiffusionSchedule,
    composed_eps: EpsModel,  # e.g. from make_classifier_free_compose_eps
    cond: torch.Tensor,  # [B, conditioned_steps, n*F]
    rollout_steps: int,
    randn: Randn,
    *,
    langevin_steps: int = 10,
    t_switch: int = 400,
    langevin_step_scale: float = 0.035,
    conditioned_steps: int = 0,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """For t > t_switch, ``langevin_steps`` ULA steps x <- x + s score +
    sqrt(2 s) xi with score = -eps / sqrt(1 - alphabar_t) and s = beta_t *
    langevin_step_scale; below, one ancestral step. With
    ``conditioned_steps > 0`` the cond frames are re-inpainted after every
    outer step. Draws: x_T, then per step the Langevin draws (or the
    ancestral step's noise), then the inpainting draw.

    Returns the frames after the conditioned ones [B, rollout, n*F]."""
    B, F = cond.shape[0], cond.shape[2]
    img = randn((B, rollout_steps, F))
    x = torch.cat([cond, img], dim=1) if conditioned_steps > 0 else img
    step_sizes = sched.betas * langevin_step_scale
    score_scale = 1.0 / sched.sqrt_one_minus_alphas_cumprod
    for t in range(sched.num_timesteps - 1, -1, -1):
        t_b = torch.full((B,), t, dtype=torch.long, device=x.device)
        if t > t_switch:
            ss = step_sizes[t]
            std = torch.sqrt(2.0 * ss)
            for _ in range(langevin_steps):
                with torch.no_grad():
                    score = -score_scale[t] * composed_eps(x, t_b)
                x = x + ss * score + std * randn(tuple(x.shape))
        else:
            x, _ = p_sample_step(sched, composed_eps, x, t, randn(tuple(x.shape)),
                                 clip_denoised=clip_denoised)
        x = _inpaint(sched, x, cond, conditioned_steps, t, t_b, randn)
    return x[:, conditioned_steps:] if conditioned_steps > 0 else x


def sample_compose_multibodies_uhmc(
    sched: DiffusionSchedule,
    composed_eps: EpsModel,
    cond: torch.Tensor,
    rollout_steps: int,
    randn: Randn,
    *,
    leapfrog_steps: int = 3,
    t_switch: int = 400,
    step_scale: float = 0.1,
    damping: float = 0.9,
    conditioned_steps: int = 0,
) -> torch.Tensor:
    """Underdamped HMC: for t > t_switch, ``leapfrog_steps`` damped
    leapfrog updates with the composed score (two eps calls each) and a
    partial momentum refresh; below, one ancestral step; cond frames
    re-inpainted as in ``sample_compose_multibodies``. Draws: x_T, the
    momentum, then per step the refresh draws (or the ancestral noise) and
    the inpainting draw."""
    B, F = cond.shape[0], cond.shape[2]
    img = randn((B, rollout_steps, F))
    x = torch.cat([cond, img], dim=1) if conditioned_steps > 0 else img
    v = randn(tuple(x.shape))
    step_sizes = sched.betas * step_scale
    score_scale = 1.0 / sched.sqrt_one_minus_alphas_cumprod
    refresh = float(np.sqrt(1 - damping ** 2))
    for t in range(sched.num_timesteps - 1, -1, -1):
        t_b = torch.full((B,), t, dtype=torch.long, device=x.device)
        if t > t_switch:
            ss = step_sizes[t]
            for _ in range(leapfrog_steps):
                with torch.no_grad():
                    v = damping * v + 0.5 * ss * (-score_scale[t] * composed_eps(x, t_b))
                    x = x + ss * v
                    v = v + 0.5 * ss * (-score_scale[t] * composed_eps(x, t_b))
                v = damping * v + refresh * randn(tuple(v.shape))
        else:
            x, _ = p_sample_step(sched, composed_eps, x, t, randn(tuple(x.shape)))
        x = _inpaint(sched, x, cond, conditioned_steps, t, t_b, randn)
    return x[:, conditioned_steps:] if conditioned_steps > 0 else x
