"""Design optimizers over forward surrogates: CEM and gradient descent.

Port of ``cindm_tpu/baselines/design_opt.py``. The JAX package's
``lax.scan`` loops are Python loops; CEM scores its whole population in one
batched rollout, and backprop takes the gradient w.r.t. the condition only.
Clamps follow the reference bounds: positions in [0.1, 0.9], velocities in
[-0.5, 0.5] (normalized).

``rollout_fn`` maps a batch of conditions [N, *cond_shape] to a batch of
predicted trajectories; ``design_fn`` maps one trajectory to a scalar (CEM
scores each candidate with ``torch.func.vmap``) or, in backprop, a batch to
the sum of its per-sample objectives. Draws come through ``randn(shape)``
in the order the JAX loops split their keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.schedules import linear_beta_schedule
from ..sampling.sampler import Randn

RolloutFn = Callable[[torch.Tensor], torch.Tensor]
DesignFn = Callable[[torch.Tensor], torch.Tensor]


def clamp_nbody_cond(cond: torch.Tensor) -> torch.Tensor:
    """Clamp each body's normalized (x, y) to [0.1, 0.9] and (vx, vy) to
    [-0.5, 0.5]; cond [..., n_bodies*4]."""
    shape = cond.shape
    c = cond.reshape(*shape[:-1], shape[-1] // 4, 4)
    return torch.cat([c[..., :2].clamp(0.1, 0.9), c[..., 2:].clamp(-0.5, 0.5)],
                     dim=-1).reshape(shape)


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    n_samples: int = 1000  # N
    n_elites: int = 100  # Ne
    n_iterations: int = 100
    init_std: float = 1.0


def cem_design(
    cfg: CEMConfig,
    rollout_fn: RolloutFn,
    design_fn: DesignFn,
    cond_shape: tuple,
    randn: Randn,
    clamp_fn: Callable = clamp_nbody_cond,
    init_mean: Optional[torch.Tensor] = None,
    batched: bool = False,
):
    """Cross-entropy method: per iteration draw N candidates ~ N(mean, std),
    clamp, score them in one batched rollout, refit (mean, std) to the Ne
    best (population std). Draws: the initial mean (unless ``init_mean``),
    then one [N, *cond_shape] draw per iteration. ``batched=True`` means
    ``design_fn`` scores a whole population [N, ...] -> [N] itself, for
    models ``torch.func.vmap`` cannot batch (GroupNorm).

    Returns (best_cond [*cond_shape], its objective, a scalar tensor)."""
    mean = clamp_fn(randn(tuple(cond_shape))) if init_mean is None else init_mean
    std = torch.full_like(mean, cfg.init_std)
    score = design_fn if batched else torch.func.vmap(design_fn)
    with torch.no_grad():
        for _ in range(cfg.n_iterations):
            eps = randn((cfg.n_samples, *cond_shape))
            cands = clamp_fn(mean[None] + std[None] * eps)
            scores = score(rollout_fn(cands))
            elites = cands[torch.topk(-scores, cfg.n_elites).indices]
            mean = elites.mean(dim=0)
            std = elites.std(dim=0, correction=0) + 1e-6
        best = clamp_fn(mean)
        return best, score(rollout_fn(best[None]))[0]


@dataclasses.dataclass(frozen=True)
class BackpropConfig:
    n_iterations: int = 1000
    coef_max_noise: float = 0.0  # annealed exploration noise scale
    lr: float = 1.0  # raw gradient steps, no optimizer


def backprop_design(
    cfg: BackpropConfig,
    rollout_fn: RolloutFn,
    design_fn: DesignFn,
    cond0: torch.Tensor,
    randn: Randn,
    clamp_fn: Callable = clamp_nbody_cond,
):
    """Gradient descent on the condition: cond <- clamp(cond - lr * grad +
    coef_i * noise), coef_i = linear_beta_schedule(n_iterations)[i] *
    coef_max_noise. One cond-shaped draw per iteration. Only the condition
    gets a gradient: the surrogate's parameters should not require one.

    Returns (cond, the objective after each iteration [n_iterations])."""
    coefs = (linear_beta_schedule(cfg.n_iterations) * cfg.coef_max_noise).astype("float32")
    cond = clamp_fn(cond0).detach()
    objs = []
    for i in range(cfg.n_iterations):
        with torch.enable_grad():
            c = cond.requires_grad_(True)
            g, = torch.autograd.grad(design_fn(rollout_fn(c)), c)
        noise = randn(tuple(cond.shape))
        with torch.no_grad():
            cond = clamp_fn(cond - cfg.lr * g + float(coefs[i]) * noise)
            objs.append(design_fn(rollout_fn(cond)))
    return cond, torch.stack(objs)
