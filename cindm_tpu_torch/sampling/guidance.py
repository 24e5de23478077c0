"""Design objectives and evaluation functions for n-body inverse design.

Port of ``cindm_tpu/sampling/guidance.py``: the design objective is the
(coef-scaled) mean-over-last-steps distance of every body's final position
to a target point, optionally plus a time-consistency penalty.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _body_positions(pos: torch.Tensor) -> torch.Tensor:
    """[..., steps, n_bodies*4] -> [..., steps, n_bodies, 2] (x, y only)."""
    *lead, T, F = pos.shape
    return pos.reshape(*lead, T, F // 4, 4)[..., :2]


def get_design_fn(
    pos_target: torch.Tensor,
    last_n_step: int,
    gamma: float = 2.0,
    coef: float | torch.Tensor = 100.0,
    time_consistency_coef: float | torch.Tensor = 0.0,
    design_fn_mode: str = "L2",
    norm_factor: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Point-attraction objective, a scalar over the batch.

    ``coef`` and ``time_consistency_coef`` may each be a scalar or a
    per-sample [B] tensor; the objective is a sum of per-sample terms, so a
    per-sample coefficient equals separate batches with scalar ones.
    ``norm_factor`` rescales the whole objective (``2 / n_bodies`` brings
    the composed gradient back to the 2-body tuning).
    """
    if pos_target.ndim != 1:
        raise ValueError("pos_target must be 1-D")
    if design_fn_mode not in ("L2", "L2square"):
        raise ValueError(design_fn_mode)
    tcc_zero = isinstance(time_consistency_coef, (int, float)) and time_consistency_coef == 0.0

    def point_objective(pos: torch.Tensor) -> torch.Tensor:
        p = _body_positions(pos)[..., -last_n_step:, :, :]  # [B, last, n, 2]
        d = (p - pos_target.to(pos.device)).abs() ** gamma
        per = d.sum(dim=-1)
        if design_fn_mode == "L2":
            per = per ** (1.0 / gamma)  # [B, last, n]
        per_sample = per.mean(dim=-2).sum(dim=-1)  # [B]
        loss_total = (per_sample * coef).sum()
        if not tcc_zero:
            xy = _body_positions(pos)
            dv = xy[:, 1:] - xy[:, :-1]
            cons = dv.square().sum(dim=(-1, -2)).mean(dim=-1)  # [B]
            loss_total = loss_total + (cons * time_consistency_coef).sum()
        return loss_total * norm_factor

    return point_objective


def get_eval_fn(
    pos_target: torch.Tensor, last_n_step: int, gamma: float = 2.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Mean final-distance metric (a scalar)."""
    if pos_target.ndim != 1:
        raise ValueError("pos_target must be 1-D")

    def eval_fn(pos: torch.Tensor) -> torch.Tensor:
        p = _body_positions(pos)[..., -last_n_step:, :, :]
        per = ((p - pos_target.to(pos.device)).abs() ** gamma).sum(dim=-1) ** (1.0 / gamma)
        return per.mean()

    return eval_fn


def get_eval_fn_per_sample(
    pos_target: torch.Tensor, last_n_step: int = 1, gamma: float = 2.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-sample losses [B]."""
    if pos_target.ndim != 1:
        raise ValueError("pos_target must be 1-D")

    def eval_fn(pos: torch.Tensor) -> torch.Tensor:
        p = _body_positions(pos)[..., -last_n_step:, :, :]
        per = ((p - pos_target.to(pos.device)).abs() ** gamma).sum(dim=-1) ** (1.0 / gamma)
        return per.reshape(per.shape[0], -1).mean(dim=-1)

    return eval_fn


def confidence_interval_95(values: torch.Tensor) -> torch.Tensor:
    """1.96 * sigma / sqrt(N) half-width (population sigma, as jnp.std)."""
    return 1.96 * values.std(correction=0) / math.sqrt(values.shape[0])
