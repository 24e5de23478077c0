"""Reference-parity loss utilities.

Port of ``custom_l1_speed_loss`` from ``cindm_tpu/utils/extras.py``: the
reference's "loss_type3", per-element L1 plus a |speed²| discrepancy channel
per body. The GNS random-walk noise and the plotting helpers come with the
slices that use them.
"""

from __future__ import annotations

import torch


def custom_l1_speed_loss(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean of [L1 per feature, |v²-v̂²| per body]; both [B, T, n_bodies*4]."""
    B, T, F = predicted.shape
    n = F // 4
    l1 = (predicted - target).abs()
    p = predicted.reshape(B, T, n, 4)
    t = target.reshape(B, T, n, 4)
    speed2 = ((p[..., 2] ** 2 + p[..., 3] ** 2) - (t[..., 2] ** 2 + t[..., 3] ** 2)).abs()
    return torch.cat([l1, speed2], dim=-1).mean()
