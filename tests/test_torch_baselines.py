"""Parity of the port's 1D baselines (cindm_tpu_torch.baselines and the
baseline branches of its train_1d) with cindm_tpu.baselines, on the same
inputs, the same weights (moved with params_from_flax) and the same draws."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cindm_tpu.baselines as jb
from cindm_tpu.data.nbody import NBodyDataset as JaxDataset
from cindm_tpu.data.nbody import NBodyDatasetConfig as JaxDatasetConfig
from cindm_tpu.sampling import guidance as jg
from cindm_tpu.utils.extras import random_walk_noise as jax_random_walk_noise
import cindm_tpu_torch.baselines as tb
from cindm_tpu_torch.cli.train_1d import build_model_and_loss
from cindm_tpu_torch.data.nbody import NBodyDataset, NBodyDatasetConfig
from cindm_tpu_torch.models import params_from_flax
from cindm_tpu_torch.sampling import guidance as tg
from torch_port_helpers import flax_grads, flax_params, keystr_flat

TOL = dict(rtol=1e-4, atol=1e-4)
GNS_CFG = dict(hidden_size=16, gnn_layers=2, radius=0.3)


def _params(model):
    """The port model's weights as the JAX package's parameter tree, and
    back through params_from_flax (the round trip must be exact)."""
    params = flax_params(model)
    back = params_from_flax(keystr_flat(params), model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items() if k in back)
    return params


def _window(B, T, n=2, seed=0):
    """Normalized n-body windows [B, T, n*4]: positions in [0.2, 0.8],
    velocities in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0.2, 0.8, (B, T, n, 2)), rng.uniform(-0.5, 0.5, (B, T, n, 2))], -1)
    return x.reshape(B, T, n * 4).astype(np.float32)


@pytest.mark.parametrize("horizon,dim", [(24, 8), (2, 16)])
def test_unet_forward_model_matches(horizon, dim):
    jm = jb.Unet1DForwardModel(horizon=horizon, transition_dim=8, dim=dim)
    tm = tb.Unet1DForwardModel(horizon, 8, dim=dim, generator=torch.Generator().manual_seed(dim))
    params = _params(tm)
    cond = _window(3, 1, seed=1)
    noise = np.random.default_rng(2).standard_normal((3, horizon, 8)).astype(np.float32)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        for nz in (noise, np.zeros_like(noise)):
            want = apply(params, jnp.asarray(cond), jnp.asarray(nz))
            got = tm(torch.from_numpy(cond), torch.from_numpy(nz) if nz is noise else None)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_his,self_edge", [(4, True), (2, False)])
def test_gns_net_and_rollouts_match(n_his, self_edge):
    k = 5
    cfg = dict(GNS_CFG, n_his=n_his, self_edge=self_edge)
    poss = np.random.default_rng(3).uniform(0.3, 0.7, (2, 3, n_his, 2)).astype(np.float32)
    ptype = np.zeros((2, 3), np.int32)
    jp, jt = jnp.asarray(poss), jnp.asarray(ptype)
    tp, tt = torch.from_numpy(poss), torch.from_numpy(ptype).long()
    for out_size, integrate in ((2, "step"), (2 * k, "direct")):
        jm = jb.GNSNet(jb.GNSConfig(out_size=out_size, **cfg))
        tm = tb.GNSNet(tb.GNSConfig(out_size=out_size, **cfg),
                       generator=torch.Generator().manual_seed(out_size))
        params = _params(tm)
        with torch.no_grad():
            np.testing.assert_allclose(tm(tp, tt).numpy(), np.asarray(jm.apply(params, jp, jt)), **TOL)
            if integrate == "step":
                want = jb.gns_rollout(jm.apply, params, jp, jt, k)
                got = tb.gns_rollout(tm, tp, tt, k)
            else:
                want = jb.gns_direct_rollout(jm.apply, params, jp, jt, k)
                got = tb.gns_direct_rollout(tm, tp, tt, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _args(method_type):
    return argparse.Namespace(method_type=method_type, seed=0, Unet_dim=8, time_interval=4,
                              gns_noise_std=6.7e-7)


def _assert_grads(model, grads, want):
    got = flax_grads(model, grads)
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def _jax_unet_loss(method_type, jm):
    """The two Unet branches' losses as the JAX CLI writes them
    (cindm_tpu/cli/train_1d.py:183-221), with the noise given."""
    if method_type == "forward_model":
        return lambda p, x, noise: jnp.mean(jnp.abs(jm.apply(p, x[:, :1], noise) - x))

    def loss(p, x, noise):
        def one(c, _):
            nxt = jm.apply(p, c)[:, -1:]
            return nxt, nxt[:, 0]

        _, traj = jax.lax.scan(one, x[:, :1], None, length=x.shape[1] - 1)
        return jnp.mean(jnp.abs(jnp.transpose(traj, (1, 0, 2)) - x[:, 1:]))

    return loss


@pytest.mark.parametrize("method_type", ["forward_model", "Unet_rollout_one"])
def test_unet_branch_losses_and_gradients_match(method_type):
    """The CLI branch's loss (build_model_and_loss) on a two-stage model,
    against the JAX CLI's: the value and every parameter's gradient."""
    x = _window(3, 8 if method_type == "forward_model" else 5, seed=4)
    noise = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    cli_model, loss_fn = build_model_and_loss(_args(method_type), 2, 8, torch.Generator())
    horizon = cli_model.horizon
    # dim 16: at T = 1 a GroupNorm of dim 8 normalises groups of one or two
    # values, where both frameworks' rounding residues dominate
    model = tb.Unet1DForwardModel(horizon, 8, dim=16, dim_mults=(1, 2),
                                  generator=torch.Generator().manual_seed(4))
    jm = jb.Unet1DForwardModel(horizon=horizon, transition_dim=8, dim=16, dim_mults=(1, 2))
    params = _params(model)
    want_v, want_g = jax.jit(jax.value_and_grad(_jax_unet_loss(method_type, jm)))(
        params, jnp.asarray(x), jnp.asarray(noise))
    loss = loss_fn(model, {"x": torch.from_numpy(x), "noise": torch.from_numpy(noise)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_v), **TOL)
    _assert_grads(model, grads, keystr_flat(want_g["params"]))


@pytest.mark.parametrize("mode", ["autoregress", "cond_one", "direct"])
def test_gns_losses_and_gradients_match(mode):
    n, T = 2, 8
    n_his = 4 if mode == "autoregress" else 2
    out_size = 2 * (T - 1) if mode == "direct" else 2
    x = _window(3, T, seed=6)
    jcfg = jb.GNSConfig(n_his=n_his, out_size=out_size, **GNS_CFG)
    jm = jb.GNSNet(jcfg)
    model = tb.GNSNet(tb.GNSConfig(n_his=n_his, out_size=out_size, **GNS_CFG),
                      generator=torch.Generator().manual_seed(2))
    params = _params(model)
    key = jax.random.PRNGKey(7)
    std = 1e-3
    noise = np.array(jax_random_walk_noise(key, (3 * n, n_his, 2), std))  # the JAX loss's own draw
    jloss = jb.make_gns_loss(jm.apply, jcfg, n, mode, noise_std=std)
    want_v, want_g = jax.jit(jax.value_and_grad(jloss))(params, {"x": jnp.asarray(x)}, key)
    loss_fn = tb.make_gns_loss(model.cfg, n, mode, noise_std=std)
    loss = loss_fn(model, {"x": torch.from_numpy(x), "noise": torch.from_numpy(noise)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_v), **TOL)
    _assert_grads(model, grads, keystr_flat(want_g["params"]))


@pytest.mark.parametrize("method_type,n_his,out_size", [
    ("GNS", 4, 2), ("GNS_cond_one", 2, 2), ("GNS_direct", 2, 46)])
def test_gns_branches_configure_as_the_jax_cli(method_type, n_his, out_size):
    """cindm_tpu/cli/train_1d.py:209-218 at horizon 24."""
    model, _ = build_model_and_loss(_args(method_type), 2, 24, torch.Generator())
    assert (model.cfg.n_his, model.cfg.out_size) == (n_his, out_size)


def test_random_walk_noise_statistics():
    """The port draws from a torch.Generator: zero first step, and the
    double-integrated accelerations have std noise_std / sqrt(n - 1) per step."""
    from cindm_tpu_torch.utils.extras import random_walk_noise

    z = random_walk_noise(torch.Generator().manual_seed(0), (20000, 3, 2), 0.5)
    assert torch.equal(z[:, 0], torch.zeros_like(z[:, 0]))
    acc = torch.diff(z, n=2, dim=1, prepend=torch.zeros_like(z[:, :1]))[:, 1:]
    assert abs(float(acc.std()) - 0.5 / 2 ** 0.5) < 0.01


def test_clamp_nbody_cond_matches():
    c = np.random.default_rng(8).uniform(-2, 2, (5, 1, 12)).astype(np.float32)
    np.testing.assert_array_equal(tb.clamp_nbody_cond(torch.from_numpy(c)).numpy(),
                                  np.asarray(jb.clamp_nbody_cond(jnp.asarray(c))))


_M = (np.random.default_rng(9).standard_normal((8, 8)) * 0.5).astype(np.float32)
_STEPS = np.arange(1, 5, dtype=np.float32)[:, None]  # a 4-frame trajectory


def _jax_rollout(c):
    return jnp.tanh(c @ _M) * _STEPS  # [..., 1, F] -> [..., 4, F]


def _torch_rollout(c):
    return torch.tanh(c @ torch.from_numpy(_M)) * torch.from_numpy(_STEPS)


class Draws:
    def __init__(self, arrays):
        self.arrays = [np.array(a) for a in arrays]

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)


def _design_fns():
    target = np.array([0.5, 0.4], np.float32)
    return (jg.get_design_fn(jnp.asarray(target), last_n_step=1, coef=1.0),
            tg.get_design_fn(torch.from_numpy(target), last_n_step=1, coef=1.0))


def test_cem_design_matches_given_jax_draws():
    cfg_j = jb.CEMConfig(n_samples=64, n_elites=8, n_iterations=3)
    cfg_t = tb.CEMConfig(n_samples=64, n_elites=8, n_iterations=3)
    jf, tf = _design_fns()
    key = jax.random.PRNGKey(10)
    best_j, obj_j = jb.cem_design(cfg_j, _jax_rollout, jf, (1, 8), key)
    k0, k1 = jax.random.split(key)
    draws = Draws([jax.random.normal(k0, (1, 8))]
                  + [jax.random.normal(k, (64, 1, 8)) for k in jax.random.split(k1, 3)])
    best_t, obj_t = tb.cem_design(cfg_t, _torch_rollout, tf, (1, 8), draws)
    assert not draws.arrays
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j), **TOL)
    np.testing.assert_allclose(float(obj_t), float(obj_j), **TOL)


def test_backprop_design_matches_given_jax_draws():
    cfg_j = jb.BackpropConfig(n_iterations=3, coef_max_noise=0.5)
    cfg_t = tb.BackpropConfig(n_iterations=3, coef_max_noise=0.5)
    jf, tf = _design_fns()
    cond0 = np.random.default_rng(11).uniform(0, 1, (4, 1, 8)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    cond_j, objs_j = jb.backprop_design(cfg_j, _jax_rollout, jf, jnp.asarray(cond0), key)
    draws = Draws([jax.random.normal(k, (4, 1, 8)) for k in jax.random.split(key, 3)])
    cond_t, objs_t = tb.backprop_design(cfg_t, _torch_rollout, tf, torch.from_numpy(cond0), draws)
    assert not draws.arrays
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), **TOL)
    np.testing.assert_allclose(objs_t.numpy(), np.asarray(objs_j), **TOL)


def test_get_gns_batch_matches():
    data = np.random.default_rng(13).uniform(0, 200, (2, 800, 2, 4)).astype(np.float32)
    idx = np.array([0, 5, 200, 377])  # 2 x 189 windows
    want = JaxDataset(JaxDatasetConfig(output_steps=10), data=data).get_gns_batch(idx, n_his=4)
    got = NBodyDataset(NBodyDatasetConfig(output_steps=10), data=data).get_gns_batch(idx, n_his=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
