"""Training: loss -> grad -> global-norm clip -> Adam -> EMA, one step at a time.

Port of the 1D part of ``cindm_tpu/train/trainer.py``. The JAX package builds
the step with optax; here the same arithmetic is written out over the
parameter list with ``torch._foreach_*`` ops, so a step launches a handful of
multi-tensor kernels instead of a few per parameter, and reads nothing back
to the host:

- ``optax.clip_by_global_norm(1.0)``: the gradients are scaled by
  ``max_norm / |g|`` only when ``|g| >= max_norm`` (no epsilon is added);
- ``optax.scale_by_adam(0.9, 0.99)``: eps 1e-8 outside the square root,
  eps_root 0, bias correction at the 1-based count of applied updates;
- ``scale_by_learning_rate(reference_lr_schedule)``: the learning rate at the
  0-based count of applied updates, StepLR(40000, 0.5) after step 600000;
- the baselines' variant, global-norm clip then ``optax.adamw``: the same
  Adam, then ``weight_decay * params`` added before the learning rate (a
  constant or ``cosine_decay_schedule``) scales the update;
- ``optax.MultiSteps(k)`` for gradient accumulation: a running mean of k
  micro-batch gradients, then one clip and Adam step; the parameters do not
  move on the other micro-steps;
- EMA (ema_pytorch's schedule): on applied steps whose (post-increment) step
  is a multiple of 10; the EMA copies the parameters while step <= 100, then
  decays at ``1 - (1 + k)^(-2/3)``, k = step - 101, clipped to [0, 0.995].

``TrainState.step`` counts applied optimizer updates, as the JAX package's
``state['step']`` does. The step functions update the state in place and
return it with the loss, which stays on the device until the caller reads it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..core.schedules import DiffusionSchedule
from ..sampling.diffusion1d import Diffusion1DConfig, p_losses
from ..sampling.diffusion2d import Diffusion2DConfig, nhwc_model, p_losses_2d

ADAM_EPS = 1e-8  # optax.scale_by_adam's default; eps_root is 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    grad_clip: float = 1.0
    ema_decay: float = 0.995
    ema_update_every: int = 10
    # ema_pytorch defaults: copy-only warm-up, then the decay ramp
    ema_update_after_step: int = 100
    ema_inv_gamma: float = 1.0
    ema_power: float = 2.0 / 3.0
    ema_min_value: float = 0.0
    lr_decay_start: int = 600_000
    lr_decay_every: int = 40_000
    lr_decay_factor: float = 0.5
    gradient_accumulate_every: int = 1


def reference_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """StepLR(lr_decay_every, lr_decay_factor) engaged after lr_decay_start."""

    def schedule(count: int) -> float:
        n = max(count - cfg.lr_decay_start, 0) // cfg.lr_decay_every
        return cfg.lr * cfg.lr_decay_factor ** n

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0: init * 0.5 * (1 + cos(pi *
    min(count, decay_steps) / decay_steps))."""

    def schedule(count: int) -> float:
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))

    return schedule


class Optimizer:
    """Global-norm clip, Adam and the learning-rate schedule, with optax's
    MultiSteps accumulation when ``gradient_accumulate_every > 1``.

    ``count`` is Adam's count of applied updates (its bias correction) and
    ``schedule_count`` the learning-rate schedule's; they move together, but
    a resume from a snapshot that carries no optimizer state seeds only the
    schedule's (``checkpoint.seed_schedule_count``), as the JAX package does.
    ``weight_decay`` and ``schedule`` (the learning rate at a count; the
    reference schedule by default) give the clip + AdamW variant.
    """

    def __init__(self, cfg: TrainConfig, params: Sequence[torch.Tensor], *,
                 weight_decay: float = 0.0, schedule: Optional[Callable[[int], float]] = None):
        self.cfg = cfg
        self.schedule = schedule or reference_lr_schedule(cfg)
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.schedule_count = 0
        self.mini_step = 0
        k = cfg.gradient_accumulate_every
        self.acc = [torch.zeros_like(p) for p in params] if k > 1 else None

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> bool:
        """Take one micro-step in place; True if the parameters moved."""
        k = self.cfg.gradient_accumulate_every
        if k > 1:
            # optax.MultiSteps' running mean: acc + (g - acc) / (mini_step + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return False
            grads = self.acc
        self._apply(params, grads)
        if k > 1:
            torch._foreach_zero_(self.acc)
        return True

    def _apply(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        cfg = self.cfg
        # clip_by_global_norm: select(|g| < max, g, (g / |g|) * max)
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < cfg.grad_clip
        one = torch.ones_like(g_norm)
        grads = torch._foreach_div(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * cfg.grad_clip))
        # scale_by_adam
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:  # add_decayed_weights
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        # scale_by_learning_rate, then apply_updates
        torch._foreach_mul_(upd, -self.schedule(self.schedule_count))
        self.schedule_count += 1
        torch._foreach_add_(params, upd)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc, "count": self.count,
                "schedule_count": self.schedule_count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), sd[name]
            if (mine is None) != (theirs is None) or len(mine or ()) != len(theirs or ()):
                raise ValueError(f"optimizer state '{name}' does not match this model/config")
            for a, b in zip(mine or (), theirs or ()):
                a.copy_(b)
        self.count, self.schedule_count = int(sd["count"]), int(sd["schedule_count"])
        self.mini_step = int(sd["mini_step"])


@dataclasses.dataclass
class TrainState:
    """The online model, its EMA copy, the optimizer state and the step."""

    model: nn.Module
    ema: nn.Module
    opt_state: Optimizer
    step: int = 0


def init_train_state(model: nn.Module, cfg: TrainConfig, **optimizer_kw) -> TrainState:
    """The state of a fresh run; ``optimizer_kw`` go to ``Optimizer``."""
    ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model, ema, Optimizer(cfg, list(model.parameters()), **optimizer_kw), 0)


def ema_decay_at(cfg: TrainConfig, step: int) -> float:
    """ema_pytorch's decay at ``step``: 0 (a copy) while step <= update_after_step."""
    if step <= cfg.ema_update_after_step:
        return 0.0
    k = max(step - cfg.ema_update_after_step - 1, 0)
    d = 1.0 - (1.0 + k / cfg.ema_inv_gamma) ** (-cfg.ema_power)
    return min(max(d, cfg.ema_min_value), cfg.ema_decay)


@torch.no_grad()
def ema_update(state: TrainState, cfg: TrainConfig) -> None:
    """ema = ema * d + params * (1 - d) on every ``ema_update_every``-th step."""
    if state.step % cfg.ema_update_every:
        return
    d = ema_decay_at(cfg, state.step)
    ema = list(state.ema.parameters())
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, list(state.model.parameters()), alpha=1.0 - d)


LossFn = Callable[[nn.Module, dict], torch.Tensor]


def make_train_step_from_loss(
    loss_fn: LossFn, train_cfg: TrainConfig
) -> Callable[[TrainState, dict], tuple[TrainState, torch.Tensor]]:
    """``step_fn(state, batch) -> (state, loss)`` for any ``loss_fn(model, batch)``:
    one micro-step (the JAX package's ``steps_per_launch`` scan of several
    has no counterpart; the host loop calls this once per micro-batch)."""

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        params = list(state.model.parameters())
        loss = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if state.opt_state.update(params, grads):
            state.step += 1
            ema_update(state, train_cfg)
        return state, loss.detach()

    return step_fn


def make_train_step(
    diffusion_cfg: Diffusion1DConfig,
    sched: DiffusionSchedule,
    train_cfg: TrainConfig,
    *,
    generator: Optional[torch.Generator] = None,
    use_kernels: bool = True,
) -> Callable[[TrainState, dict], tuple[TrainState, torch.Tensor]]:
    """1D-diffusion train step over batch = {'x': [B, rollout, F],
    'cond': [B, cond, F] (optional)}. ``t`` and ``noise`` are drawn from
    ``generator`` unless the batch carries them (keys 't' and 'noise').
    ``use_kernels`` picks the denoiser's CUDA kernels or its plain path."""

    def loss_fn(model: nn.Module, batch: dict) -> torch.Tensor:
        return p_losses(
            diffusion_cfg, sched, lambda x, t: model(x, t, use_kernels),
            batch["x"], batch.get("cond"),
            t=batch.get("t"), noise=batch.get("noise"), generator=generator,
        )

    return make_train_step_from_loss(loss_fn, train_cfg)


def make_train_step_2d(
    diffusion_cfg: Diffusion2DConfig,
    sched: DiffusionSchedule,
    train_cfg: TrainConfig,
    *,
    generator: Optional[torch.Generator] = None,
) -> Callable[[TrainState, dict], tuple[TrainState, torch.Tensor]]:
    """2D-diffusion train step over batch = {'x': [B, H, W, pred*3+3],
    'cond': [B, H, W, cond*3]} (channel-last, as the datasets give them) for
    an NCHW model. ``t``, ``noise`` and ``noise_cond`` are drawn from
    ``generator`` unless the batch carries them."""

    def loss_fn(model: nn.Module, batch: dict) -> torch.Tensor:
        return p_losses_2d(diffusion_cfg, sched, nhwc_model(model), batch["x"], batch["cond"],
                           t=batch.get("t"), noise=batch.get("noise"),
                           noise_cond=batch.get("noise_cond"), generator=generator)

    return make_train_step_from_loss(loss_fn, train_cfg)
