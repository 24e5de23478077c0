"""Parity of the port's 2D training pieces with the JAX package:
``p_losses_2d`` over every branch (diffuse_cond on and off; pred_noise,
pred_x0, pred_v; l1, l2; SNR and min-SNR weights) with the JAX draws
replayed in key order (<= 1e-5 relative); one ``make_train_step_2d`` step
of a small Unet2D (every gradient within 1e-4 of its leaf's largest entry);
``Unet2D(remat=True)`` against the plain model (<= 1e-6) and its recompute;
the clip + AdamW optimizer with a cosine schedule against optax's.

Images are channel-last numpy arrays from a seed, as both packages' 2D
losses take them; the port's Unet2D takes NCHW behind ``nhwc_model``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cindm_tpu.core import make_schedule as j_make_schedule
from cindm_tpu.models.unet2d import Unet2D as JUnet2D
from cindm_tpu.sampling import diffusion2d as jd2
from cindm_tpu_torch.core.schedules import make_schedule as t_make_schedule
from cindm_tpu_torch.models import Unet2D, params_from_flax
from cindm_tpu_torch.sampling import diffusion2d as td2
from cindm_tpu_torch.train import (Optimizer, TrainConfig, cosine_decay_schedule, init_train_state,
                                   make_train_step_2d)
from torch_port_helpers import flax_grads, keystr_flat

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
HW, T = 8, 20

# (diffuse_cond, objective, loss_type, min_snr_loss_weight); pred_x0 and
# pred_v score the pred channels only, so they run without diffuse_cond
BRANCHES = [
    (True, "pred_noise", "l2", False),
    (True, "pred_noise", "l1", True),
    (False, "pred_noise", "l2", True),
    (False, "pred_x0", "l2", False),
    (False, "pred_x0", "l1", True),
    (False, "pred_v", "l1", False),
    (False, "pred_v", "l2", True),
]


def _cfgs(**kw):
    common = dict(image_size=HW, frames=3, cond_frames=1, pred_frames=2, timesteps=T, **kw)
    return jd2.Diffusion2DConfig(**common), td2.Diffusion2DConfig(**common)


def _inputs(B=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, HW, HW, 9)).astype(np.float32)
    cond = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    return x, cond


def _jax_draws(cfg, x, cond, key):
    """p_losses_2d's draws, in its key order: t, noise, then the cond noise."""
    kt, kn, kc = jax.random.split(key, 3)
    t = jax.random.randint(kt, (x.shape[0],), 0, cfg.timesteps)
    noise = jax.random.normal(kn, x.shape, jnp.float32)
    noise_cond = jax.random.normal(kc, cond.shape, jnp.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("t", t), ("noise", noise), ("noise_cond", noise_cond))}


@pytest.mark.parametrize("branch", BRANCHES, ids=lambda b: "-".join(map(str, b)))
def test_p_losses_2d_matches(branch):
    diffuse_cond, objective, loss_type, min_snr = branch
    jcfg, tcfg = _cfgs(diffuse_cond=diffuse_cond, objective=objective, loss_type=loss_type,
                       min_snr_loss_weight=min_snr)
    x, cond = _inputs()
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((12, 12)) / 4).astype(np.float32)
    emb = rng.standard_normal((T, 12)).astype(np.float32)
    # a small channel-mixing eps model, the same in both packages
    j_eps = lambda z, t: jnp.tanh(z @ w) + jnp.asarray(emb)[t][:, None, None, :]
    t_eps = lambda z, t: torch.tanh(z @ torch.from_numpy(w)) + torch.from_numpy(emb)[t][:, None, None, :]
    key = jax.random.PRNGKey(7)
    want = float(jd2.p_losses_2d(jcfg, j_make_schedule(T, "sigmoid"), j_eps, jnp.asarray(x),
                                 jnp.asarray(cond), key))
    draws = _jax_draws(jcfg, x, cond, key)
    got = float(td2.p_losses_2d(tcfg, t_make_schedule(T, "sigmoid", device="cpu"), t_eps,
                                torch.from_numpy(x), torch.from_numpy(cond), **draws))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    # the draws from a generator: t, noise, cond noise, in that order
    g = torch.Generator().manual_seed(3)
    t = torch.randint(0, T, (3,), generator=g)
    noise = torch.randn((3, HW, HW, 9), generator=g)
    replay = dict(t=t, noise=noise)
    if diffuse_cond:
        replay["noise_cond"] = torch.randn((3, HW, HW, 3), generator=g)
    sched = t_make_schedule(T, "sigmoid", device="cpu")
    a = td2.p_losses_2d(tcfg, sched, t_eps, torch.from_numpy(x), torch.from_numpy(cond),
                        generator=torch.Generator().manual_seed(3))
    b = td2.p_losses_2d(tcfg, sched, t_eps, torch.from_numpy(x), torch.from_numpy(cond), **replay)
    assert float(a) == float(b)


def _small_unet(seed=0):
    # dim 16: two channels or more per GroupNorm group, so no conv bias has a
    # gradient that is zero in exact arithmetic
    jm = JUnet2D(dim=16, dim_mults=(1,), channels=12)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 12)),
                              jnp.zeros((1,), jnp.int32))
    # move the norm gains and biases off 1 and 0
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), params)
    tm = Unet2D(dim=16, dim_mults=(1,), channels=12)
    tm.load_state_dict(params_from_flax(keystr_flat(params["params"]), tm))
    return jm, params, tm


def test_train_step_2d_gradients_match():
    jm, params, tm = _small_unet()
    jcfg, tcfg = _cfgs()
    x, cond = _inputs(B=2)
    key = jax.random.PRNGKey(11)
    sched = j_make_schedule(T, "sigmoid")

    def loss_fn(p):
        return jd2.p_losses_2d(jcfg, sched, lambda z, t: jm.apply(p, z, t), jnp.asarray(x),
                               jnp.asarray(cond), key)

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = keystr_flat(jg["params"])
    train_cfg = TrainConfig()
    state = init_train_state(tm, train_cfg)
    captured = []
    update = state.opt_state.update
    state.opt_state.update = lambda p, g: (captured.extend(g), update(p, g))[1]
    step = make_train_step_2d(tcfg, t_make_schedule(T, "sigmoid", device="cpu"), train_cfg)
    before = [p.detach().clone() for p in tm.parameters()]
    batch = {"x": torch.from_numpy(x), "cond": torch.from_numpy(cond),
             **_jax_draws(jcfg, x, cond, key)}
    _, loss = step(state, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    got = flax_grads(tm, captured)
    assert set(got) == set(jg)
    for k, want in jg.items():
        want = np.asarray(want)
        assert np.abs(got[k] - want).max() <= GRAD_TOL * np.abs(want).max(), k
    assert state.step == 1 and any(not torch.equal(a, b) for a, b in zip(before, tm.parameters()))


def test_unet2d_remat_equals_plain_and_recomputes():
    g = torch.Generator().manual_seed(0)
    plain = Unet2D(dim=8, dim_mults=(1, 2), channels=12, generator=g)
    remat = Unet2D(dim=8, dim_mults=(1, 2), channels=12, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn((2, 12, HW, HW), generator=g)
    t = torch.tensor([3, 11])
    calls = []
    remat.rbs[0].register_forward_pre_hook(lambda *a: calls.append(1))
    outs, grads = [], []
    for m in (plain, remat):
        y = m(x, t)
        outs.append(y)
        grads.append(torch.autograd.grad(y.square().sum(), list(m.parameters())))
    assert (outs[1] - outs[0]).abs().max() <= REMAT_TOL * outs[0].abs().max()
    for a, b in zip(grads[1], grads[0]):
        assert (a - b).abs().max() <= REMAT_TOL * b.abs().max().clamp_min(1e-30)
    assert len(calls) == 2  # the forward, then the backward's recompute
    with torch.no_grad():  # no grad, no checkpoint
        remat(x, t)
    assert len(calls) == 3
    assert list(dict(remat.named_parameters())) == list(dict(plain.named_parameters()))


@pytest.mark.parametrize("schedule", ["cos", "none"])
def test_adamw_matches_optax(schedule):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(2.0 * rng.standard_normal(s)).astype(np.float32) for s in shapes] for _ in range(4)]
    lr, wd, total = 1e-2, 0.1, 3
    cfg = TrainConfig(lr=lr)
    lr_sched = optax.cosine_decay_schedule(lr, total) if schedule == "cos" else lr
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adamw(lr_sched, b1=cfg.adam_b1, b2=cfg.adam_b2, weight_decay=wd))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = Optimizer(cfg, tp, weight_decay=wd,
                    schedule=cosine_decay_schedule(lr, total) if schedule == "cos" else (lambda c: lr))
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
