"""Compositional eps-model: multi-body x multi-window denoising as one batched forward.

Port of ``cindm_tpu/sampling/compose.py``. A 2-body, single-window denoiser
is lifted to n bodies over (n_composed + 1) overlapping time windows:

    x [B, T_tot, n*4]
      -> K windows x P body pairs gathered into one batch [K*P*B, sms, 8]
      -> one denoiser forward (or ``fold_chunks`` sequential slices of it)
      -> pair contributions scattered back to bodies (one-hot ``A``)
      -> window-overlap normalised mean or sum.
"""

from __future__ import annotations

import itertools
from typing import Callable, Literal

import numpy as np
import torch

from ..core import diffusion as dd

EpsModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x [B,T,F], t [B]) -> eps


def pair_indices(n_bodies: int) -> tuple[np.ndarray, np.ndarray]:
    """All i<j body pairs."""
    pairs = list(itertools.combinations(range(n_bodies), 2))
    pi = np.array([p[0] for p in pairs], dtype=np.int64)
    pj = np.array([p[1] for p in pairs], dtype=np.int64)
    return pi, pj


def window_coverage(
    total_steps: int, n_composed: int, compose_start_step: int, single_model_step: int
) -> np.ndarray:
    """How many windows cover each time step. Shape [total_steps]."""
    cov = np.zeros(total_steps, dtype=np.float32)
    for kk in range(n_composed + 1):
        cov[kk * compose_start_step : kk * compose_start_step + single_model_step] += 1.0
    return cov


# Target size of one denoiser call's folded (window, pair, batch) axis. The
# rule below is the JAX package's; the value is the card's. chip_smoke.py's
# denoiser phase times the full-width TemporalUnet1D forward (kernel path)
# per sample at folds of 1,344 / 2,688 / 5,376 / 10,752: 9.97 / 5.32 / 3.90
# / 3.65 us on an NVIDIA H100 80GB HBM3 at 700.00 W. The time per sample still
# falls at 10,752, the largest fold measured, so one call takes up to that.
FOLD_TARGET = 10752


def resolve_fold_chunks(n_fold: int, requested: int = 0) -> int:
    """Number of sequential denoiser calls for a folded axis of ``n_fold``.

    A nonzero ``requested`` is used as given when it is positive and divides
    ``n_fold`` (else one call). 0 picks the smallest divisor of ``n_fold`` that brings each call to
    at most ~FOLD_TARGET samples, searching up to 4x the minimum count; one
    call when there is none.
    """
    if requested != 0:
        return requested if requested > 0 and n_fold % requested == 0 else 1
    if n_fold <= FOLD_TARGET:
        return 1
    lo = -(-n_fold // FOLD_TARGET)
    return next((f for f in range(lo, min(4 * lo, n_fold) + 1) if n_fold % f == 0), 1)


def clip_pair_eps(sched, pair_in: torch.Tensor, t_rep: torch.Tensor,
                          eps: torch.Tensor) -> torch.Tensor:
    """Outside composition: clip each pair-window's x0 estimate to [-1, 1] and
    re-derive its eps before aggregation."""
    x_start = dd.predict_start_from_noise(sched, pair_in, t_rep, eps).clamp(-1.0, 1.0)
    return dd.predict_noise_from_start(sched, pair_in, t_rep, x_start)


def make_composed_eps_model(
    base_eps_model: EpsModel,
    *,
    compose_n_bodies: int,
    n_composed: int,
    compose_start_step: int,
    single_model_step: int,
    compose_mode: Literal["mean-inside", "sum-inside"] = "mean-inside",
    feature_size: int = 4,
    sched=None,
    clip_pairwise_x_start: bool = False,
    fold_chunks: int = 0,
) -> EpsModel:
    """Lift a 2-body single-window eps-model to n bodies over composed windows.

    The result has the plain EpsModel signature. ``clip_pairwise_x_start``
    gives the outside-composition semantics and needs ``sched``.
    ``fold_chunks`` is resolved per call by ``resolve_fold_chunks``.
    """
    if compose_mode not in ("mean-inside", "sum-inside"):
        raise ValueError(f"unknown compose_mode {compose_mode}")
    if clip_pairwise_x_start and sched is None:
        raise ValueError("clip_pairwise_x_start requires sched")
    n = compose_n_bodies
    K = n_composed + 1
    css, sms, F = compose_start_step, single_model_step, feature_size
    T_tot = sms + n_composed * css
    pi, pj = pair_indices(n)
    P = len(pi)
    A = np.zeros((P, 2, n), dtype=np.float32)
    A[np.arange(P), 0, pi] = 1.0
    A[np.arange(P), 1, pj] = 1.0
    cov = window_coverage(T_tot, n_composed, css, sms)
    consts: dict = {}

    def on(device):
        if device not in consts:
            consts[device] = tuple(
                torch.as_tensor(a, device=device) for a in (A, cov, pi, pj)
            )
        return consts[device]

    def eps_model(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if x.shape[1] != T_tot or x.shape[2] != n * F:
            raise ValueError(f"composed eps-model expects [B, {T_tot}, {n * F}], got {tuple(x.shape)}")
        A_t, cov_t, pi_t, pj_t = on(x.device)
        xb = x.reshape(B, T_tot, n, F)
        xw = torch.stack([xb[:, kk * css : kk * css + sms] for kk in range(K)], dim=0)
        pair_in = torch.cat([xw[:, :, :, pi_t], xw[:, :, :, pj_t]], dim=-1)  # [K,B,sms,P,2F]
        pair_in = pair_in.permute(0, 3, 1, 2, 4).reshape(K * P * B, sms, 2 * F)
        t_rep = t.repeat(K * P)
        n_fold = K * P * B
        fc = resolve_fold_chunks(n_fold, fold_chunks)
        if fc > 1:
            eps = torch.cat([
                base_eps_model(a, b)
                for a, b in zip(pair_in.chunk(fc), t_rep.chunk(fc))
            ])
        else:
            eps = base_eps_model(pair_in, t_rep)
        if clip_pairwise_x_start:
            eps = clip_pair_eps(sched, pair_in, t_rep, eps)
        eps = eps.reshape(K, P, B, sms, 2, F).permute(0, 2, 3, 1, 4, 5)  # [K,B,sms,P,2,F]
        agg = torch.einsum("kbspcf,pcn->kbsnf", eps, A_t)
        if compose_mode == "mean-inside":
            agg = agg / (n - 1)
        agg = agg.reshape(K, B, sms, n * F)
        out = torch.zeros((B, T_tot, n * F), dtype=x.dtype, device=x.device)
        for kk in range(K):
            out[:, kk * css : kk * css + sms] += agg[kk]
        if compose_mode == "mean-inside":
            return out / cov_t[None, :, None]
        return out / (cov_t[None, :, None] / K)

    return eps_model
