"""Shared pieces of the surrogate-training harness (the le_pde flag semantics
the paper's baseline recipes use).

Port of ``cindm_tpu/baselines/harness.py``:

- ``parse_multi_step``: the weighted multi-step loss spec, "1^2:1e-2^4:1e-3"
  -> {1: 1.0, 2: 1e-2, 4: 1e-3}; a bare "k" entry gets weight 1.
- ``loss_core``: "mse" | "l1" | "huber" elementwise-mean losses.
- ``multi_step_loss``: autoregressive rollout to max(step) with the per-step
  weights applied only at the listed steps.
- ``experiment_record``: a hash-named JSON record {args, history, final}.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable

import torch


def parse_multi_step(spec: str) -> dict[int, float]:
    """"1^2:1e-2^4:1e-3" -> {1: 1.0, 2: 0.01, 4: 0.001}."""
    out: dict[int, float] = {}
    for part in str(spec).split("^"):
        if not part:
            continue
        if ":" in part:
            k, w = part.split(":")
            out[int(k)] = float(w)
        else:
            out[int(part)] = 1.0
    if not out:
        raise ValueError(f"empty multi_step spec {spec!r}")
    return out


def loss_core(pred: torch.Tensor, target: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Elementwise-mean loss."""
    diff = pred - target
    if loss_type == "mse":
        return diff.square().mean()
    if loss_type == "l1":
        return diff.abs().mean()
    if loss_type == "huber":
        a = diff.abs()
        return torch.where(a < 1.0, 0.5 * diff.square(), a - 0.5).mean()
    raise ValueError(f"unknown loss_type {loss_type!r}")


def multi_step_loss(
    step_fn: Callable[[torch.Tensor], torch.Tensor],
    u0: torch.Tensor,
    targets: torch.Tensor,  # [B, K, ...] with K >= max(multi_step_dict)
    multi_step_dict: dict[int, float],
    loss_type: str = "mse",
) -> torch.Tensor:
    """Roll ``step_fn`` to max(step); add weight * loss at the listed steps
    only; divide by the sum of the weights."""
    loss = u0.new_zeros(())
    cur = u0
    for i in range(1, max(multi_step_dict) + 1):
        cur = step_fn(cur)
        if i in multi_step_dict:
            loss = loss + multi_step_dict[i] * loss_core(cur, targets[:, i - 1], loss_type)
    return loss / sum(multi_step_dict.values())


def experiment_record(results_folder: str, args_dict: dict, history: list[dict],
                      final: dict) -> str:
    """Write ``record_<sha1(args)[:10]>.json`` = {args, per-epoch history,
    final metrics, time} under ``results_folder``; returns its path."""
    payload = {"args": args_dict, "history": history, "final": final,
               "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    h = hashlib.sha1(json.dumps(args_dict, sort_keys=True).encode()).hexdigest()[:10]
    os.makedirs(results_folder, exist_ok=True)
    path = os.path.join(results_folder, f"record_{h}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path
