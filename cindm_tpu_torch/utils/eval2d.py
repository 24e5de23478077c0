"""2D design evaluation: closed-loop BDIM scoring and lift/drag metrics.

Port of ``cindm_tpu/utils/eval2d.py``: the designed boundaries are
re-simulated by the port's batched BDIM solver (``physics.bdim``) and
scored as

    obj  = -|lift| + lam * |drag|        (minimize)
    frac = |lift / drag|                 (maximize)

averaged over the recorded steps, best over the batch. The metrics are
numpy, computed on the host from the solver's forces.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..physics.bdim import BDIMConfig, simulate_flow_batch
from .device import resolve_device


def metric(lift, drag, lam: float = 1.0, use_frac: bool = False):
    lift = np.asarray(lift)
    drag = np.asarray(drag)
    if use_frac:
        return np.abs(lift / drag)
    return -np.abs(lift) + lam * np.abs(drag)


def metric_batch(forces: np.ndarray, lam: float = 1.0):
    """forces: [B, T, K, 2] (drag, lift). Returns (drag_min, lift_max,
    obj_min, lift_over_drag_max) over the batch."""
    drag = forces[..., 0].sum(axis=2)  # [B, T]
    lift = forces[..., 1].sum(axis=2)
    drag_mean = drag.mean(axis=1)
    lift_mean = lift.mean(axis=1)
    obj = metric(lift, drag, lam).mean(axis=1)
    frac = metric(lift, drag, lam, use_frac=True).mean(axis=1)
    return (
        float(np.min(np.abs(drag_mean))),
        float(np.max(np.abs(lift_mean))),
        float(np.min(np.abs(obj))),
        float(np.max(np.abs(frac))),
    )


def chord_lengths(boundaries: np.ndarray) -> np.ndarray:
    """Streamwise extent of each polygon in grid cells: [B, K, M, 2] -> [B, K]
    (the freestream is +x)."""
    b = np.asarray(boundaries)
    return b[..., 0].max(axis=-1) - b[..., 0].min(axis=-1)


def force_coefficients(forces: np.ndarray, boundaries: np.ndarray, u_inf: float = 1.0):
    """C = F / (0.5 rho U^2 D), rho = 1, D the summed chord of a design's
    boundaries. forces [B, T, K, 2] -> (Cd, Cl), each [B, T]."""
    q = 0.5 * u_inf * u_inf * np.maximum(chord_lengths(boundaries).sum(axis=1), 1e-6)  # [B]
    drag = forces[..., 0].sum(axis=2) / q[:, None]
    lift = forces[..., 1].sum(axis=2) / q[:, None]
    return drag, lift


def evaluate_designs(boundaries: np.ndarray, bdim_cfg: Optional[BDIMConfig] = None,
                     n_warmup: int = 300, n_record: int = 100, lam: float = 1.0,
                     device: str | torch.device = "cuda"):
    """Closed-loop scoring: re-simulate the polygons [B, K, M, 2] (grid
    units) with BDIM, all B designs in one batch on ``device``, and compute
    the metrics. Returns a dict with forces [B, T, K, 2], the four batch
    metrics and the force coefficients."""
    cfg = bdim_cfg or BDIMConfig()
    boundaries = np.asarray(boundaries, np.float32)
    _, forces = simulate_flow_batch(cfg, boundaries, n_warmup, n_record,
                                    device=resolve_device(device))
    forces = forces.cpu().numpy()
    drag_min, lift_max, obj_min, frac_max = metric_batch(forces, lam)
    cd, cl = force_coefficients(forces, boundaries, cfg.u_inf)
    cd_mean, cl_mean = cd.mean(axis=1), cl.mean(axis=1)
    return {
        "forces": forces,
        "drag_min": drag_min,
        "lift_max": lift_max,
        "obj_min": obj_min,
        "lift_over_drag_max": frac_max,
        # dimensionless (divided by 0.5 U^2 times the total chord)
        "cd_min": float(np.min(np.abs(cd_mean))),
        "cl_max": float(np.max(np.abs(cl_mean))),
        "cd_per_design": cd_mean,
        "cl_per_design": cl_mean,
    }
