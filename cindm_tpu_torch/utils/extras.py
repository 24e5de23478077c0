"""Reference-parity utilities: the speed loss, GNS noise, plots.

Port of ``cindm_tpu/utils/extras.py``:

- ``custom_l1_speed_loss``: the reference's "loss_type3", per-element L1
  plus a |speed²| discrepancy channel per body;
- ``random_walk_noise``: GNS training noise, accelerations ~ N(0, σ/√n)
  integrated twice, drawn from a ``torch.Generator``;
- ``plot_trajectories`` / ``plot_field``: trajectory and field figures.
  They import matplotlib when called; nothing on the card's paths calls them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def random_walk_noise(generator: Optional[torch.Generator], pos_seq_shape: tuple,
                      noise_std: float, device: str | torch.device = "cpu") -> torch.Tensor:
    """GNS random-walk position noise of shape [n_particles, n_steps, dim]:
    zero at the first step, then the double cumulative sum of accelerations
    ~ N(0, noise_std / sqrt(n_steps - 1)) (one step: N(0, noise_std))."""
    n, steps, d = pos_seq_shape
    if steps == 1:
        acc = torch.randn((n, 1, d), generator=generator, device=device) * noise_std
        return acc.cumsum(dim=1).cumsum(dim=1)
    nv = steps - 1
    acc = torch.randn((n, nv, d), generator=generator, device=device) * (noise_std / nv ** 0.5)
    pos = acc.cumsum(dim=1).cumsum(dim=1)
    return torch.cat([torch.zeros_like(pos[:, :1]), pos], dim=1)


def plot_trajectories(trajs: np.ndarray, target: Optional[tuple] = None,
                      path: Optional[str] = None, max_plots: int = 16):
    """Scatter plots of normalized trajectories [B, T, n_bodies*4], final
    positions starred, the target crossed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    B = min(trajs.shape[0], max_plots)
    n = trajs.shape[-1] // 4
    cols = int(np.ceil(np.sqrt(B)))
    rows = int(np.ceil(B / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for b in range(B):
        ax = axes[b // cols][b % cols]
        tr = trajs[b].reshape(-1, n, 4)
        for j in range(n):
            ax.plot(tr[:, j, 0], tr[:, j, 1], "-o", ms=2, lw=0.8)
            ax.plot(tr[-1, j, 0], tr[-1, j, 1], "r*", ms=8)
        if target is not None:
            ax.plot([target[0]], [target[1]], "kx", ms=10)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig


def plot_field(field: np.ndarray, path: Optional[str] = None, titles: Optional[list] = None):
    """Heatmaps of a field [H, W] or [H, W, C], one panel per channel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = field if field.ndim == 3 else field[..., None]
    C = f.shape[-1]
    fig, axes = plt.subplots(1, C, figsize=(4 * C, 4), squeeze=False)
    for c in range(C):
        im = axes[0][c].imshow(f[..., c], cmap="RdBu_r")
        fig.colorbar(im, ax=axes[0][c])
        if titles:
            axes[0][c].set_title(titles[c])
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig
