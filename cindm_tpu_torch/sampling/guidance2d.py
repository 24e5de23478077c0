"""2D design objectives: the ForceUnet lift/drag surrogate and the overlap
and separation penalties.

Port of ``cindm_tpu/sampling/guidance2d.py``. ``make_design_grad_fn``
returns the gradient, w.r.t. the whole state x, of

    lambda_force * sum_frames (lambda * |drag| + lift)
    + lambda_overlap * pairwise mask overlap + lambda_separation * separation

which is what the 2D sampler subtracts. x is [B*nb, H, W, C] channel-last
(per frame vx, vy, p; the last 3 channels mask, offx, offy), the layout of
``diffusion2d``; ``force_model`` takes NCHW input [N, 4, H, W]
(pressure, mask, offx, offy) and returns [N, 2] (drag, lift), as
``models.ForceUnet`` does.
"""

from __future__ import annotations

from typing import Callable

import torch

ForceModel = Callable[[torch.Tensor], torch.Tensor]


def unnormalize_state(pressure: torch.Tensor, p_min: float, p_max: float) -> torch.Tensor:
    """[-1, 1] -> [p_min, p_max]."""
    return (0.5 * pressure + 0.5) * (p_max - p_min) + p_min


def compute_overlap(matrix: torch.Tensor) -> torch.Tensor:
    """Mean pairwise inner product across boundaries: [B, nb, D] -> [B]."""
    inner = torch.einsum("bnd,bmd->bnm", matrix, matrix)
    nb = matrix.shape[1]
    inner = inner * (1.0 - torch.eye(nb, device=matrix.device, dtype=matrix.dtype))[None]
    return inner.mean(dim=(-2, -1))


def force_objective(x: torch.Tensor, force_model: ForceModel, batch_size: int, num_boundaries: int,
                    frames: int, p_min: float, p_max: float, lambda_force: float = 1.0) -> torch.Tensor:
    """Sum over designs and frames of lambda * |drag| + lift, the boundary
    channels summed over the boundaries (clipped to [0, 1]) before scoring.
    All frames go through ``force_model`` in one call."""
    Bnb, H, W, _ = x.shape
    boundary = x[..., -3:].reshape(batch_size, num_boundaries, H, W, 3)
    boundary = boundary.sum(dim=1, keepdim=True).clamp(0.0, 1.0)
    boundary = boundary.expand(batch_size, num_boundaries, H, W, 3).reshape(Bnb, H, W, 3)
    pressures = torch.stack([unnormalize_state(x[..., 2 + 3 * i], p_min, p_max)
                             for i in range(frames)], dim=1)  # [B*nb, frames, H, W]
    bframes = boundary.permute(0, 3, 1, 2)[:, None].expand(Bnb, frames, 3, H, W)
    inp = torch.cat([pressures[:, :, None], bframes], dim=2).reshape(Bnb * frames, 4, H, W)
    ld = force_model(inp)  # [B*nb*frames, 2] (drag, lift)
    return (lambda_force * ld[:, 0].abs() + ld[:, 1]).sum()


def overlap_objective(x: torch.Tensor, batch_size: int, num_boundaries: int,
                      downsampling_factor: int = 4) -> torch.Tensor:
    """Sum over designs of the mean pairwise overlap of the downsampled masks."""
    H, W = x.shape[1], x.shape[2]
    f = downsampling_factor
    mask = x[..., -3].clamp(0.0, 1.0).reshape(batch_size, num_boundaries, H, W)
    m = mask.reshape(batch_size, num_boundaries, H // f, f, W // f, f).mean(dim=(3, 5))
    return compute_overlap(m.reshape(batch_size, num_boundaries, -1)).sum()


def mask_centroids(x: torch.Tensor, batch_size: int, num_boundaries: int) -> torch.Tensor:
    """Soft centroid (row, col) of each boundary's mask channel: [B, nb, 2] in cells."""
    H, W = x.shape[1], x.shape[2]
    mask = x[..., -3].clamp(0.0, 1.0).reshape(batch_size, num_boundaries, H, W)
    tot = mask.sum(dim=(-2, -1)) + 1e-6
    ar = lambda n: torch.arange(n, device=x.device, dtype=x.dtype)
    rows = (mask * ar(H)[None, None, :, None]).sum(dim=(-2, -1)) / tot
    cols = (mask * ar(W)[None, None, None, :]).sum(dim=(-2, -1)) / tot
    return torch.stack([rows, cols], dim=-1)


def separation_objective(x: torch.Tensor, batch_size: int, num_boundaries: int,
                         scale: float = 12.0) -> torch.Tensor:
    """Sum over pairs i < j of exp(-d^2 / 2 s^2) of the mask-centroid
    distances: descending it moves the centroids apart."""
    c = mask_centroids(x, batch_size, num_boundaries)
    d2 = (c[:, :, None] - c[:, None, :]).square().sum(dim=-1)
    off = 1.0 - torch.eye(num_boundaries, device=x.device, dtype=x.dtype)[None]
    return (torch.exp(-d2 / (2.0 * scale * scale)) * off).sum() / 2.0


def make_design_grad_fn(force_model: ForceModel, batch_size: int, num_boundaries: int, frames: int,
                        p_min: float, p_max: float, lambda_force: float = 1.0,
                        lambda_overlap: float = 1.0,
                        lambda_separation: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """design_fn(x) -> the gradient of the objective w.r.t. x
    (``torch.autograd.grad``; x itself is not modified)."""

    def objective(x):
        obj = force_objective(x, force_model, batch_size, num_boundaries, frames, p_min, p_max,
                              lambda_force)
        if num_boundaries > 1 and lambda_overlap != 0.0:
            obj = obj + lambda_overlap * overlap_objective(x, batch_size, num_boundaries)
        if num_boundaries > 1 and lambda_separation != 0.0:
            obj = obj + lambda_separation * separation_objective(x, batch_size, num_boundaries)
        return obj

    def design_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            return torch.autograd.grad(objective(xg), xg)[0]

    return design_fn


def mask_denoise(x: torch.Tensor, thre: float = 0.5) -> torch.Tensor:
    """Threshold a soft mask to binary."""
    return (x > thre).to(x.dtype)
