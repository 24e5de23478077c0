"""Parity of the port's time-composition and multibody samplers
(cindm_tpu_torch.sampling.compose_time) with cindm_tpu.sampling.compose_time.

The JAX samplers split PRNG keys; each test makes the same splits with
jax.random and hands the draws the JAX code uses, in its order, to the
port's ``randn`` hook. The arithmetic is held with small closed-form
eps-models written in both frameworks; one case per sampler runs a dim-8
TemporalUnet1D with the same weights in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.sampling import compose_time as jct
from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.sampling import compose_time as tct
from torch_port_helpers import flax_params, port_model

TOL = dict(rtol=1e-4, atol=1e-4)
T_STEPS = 6  # diffusion timesteps of every test's schedule

_M8 = (np.random.default_rng(0).standard_normal((8, 8)) * 0.3).astype(np.float32)
_M4 = (np.random.default_rng(1).standard_normal((4, 4)) * 0.3).astype(np.float32)


def _closed_form(m, dt):
    """A fake eps-model tanh(x M + dt t) in both frameworks, nonlinear in x, dependent on t."""
    j = lambda x, t: jnp.tanh(x @ m + dt * t[:, None, None].astype(jnp.float32))
    t_ = lambda x, t: torch.tanh(x @ torch.from_numpy(m) + dt * t[:, None, None].float())
    return j, t_


PAIR = _closed_form(_M8, 0.01)
UNCOND = _closed_form(_M4, 0.02)


@pytest.fixture(scope="module")
def unets():
    """(jax eps, port eps) of a dim-8 2-body TemporalUnet1D and of a 1-body one."""
    out = {}
    for name, F in (("pair", 8), ("uncond", 4)):
        m = port_model(dim=8, seed=F, horizon=8, transition_dim=F)
        jm, p = JaxUnet(horizon=8, transition_dim=F, dim=8), flax_params(m)
        out[name] = (jax.jit(lambda x, t, jm=jm, p=p: jm.apply(p, x, t)),
                     lambda x, t, m=m: m(x, t))
    return out


class Draws:
    """Replays pre-made draws in order, checking each requested shape."""

    def __init__(self, arrays):
        self.arrays = [np.array(a) for a in arrays]

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def _ddim_draws(key, shape, steps):
    """ddim_sample_loop's draws without cond: x_T, then one noise a step."""
    key, k0 = jax.random.split(key)
    out = [_normal(k0, shape)]
    for _ in range(steps):
        key, k1, _, _ = jax.random.split(key, 4)
        out.append(_normal(k1, shape))
    return out


def _schedules():
    return jax_make_schedule(T_STEPS), make_schedule(T_STEPS, device="cpu")


def _eps(kind, unets):
    return unets["pair"] if kind == "unet" else PAIR


@pytest.mark.parametrize("kind,n_composed", [("closed", 1), ("closed", 2), ("unet", 2)])
def test_composing_time_sample_matches(kind, n_composed, unets):
    B, R, cs, F = 2, 7, 1, 8
    js, ts = _schedules()
    jeps, teps = _eps(kind, unets)
    cond = np.random.default_rng(2).uniform(-1, 1, (B, cs, F)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j0, jst = jct.composing_time_sample(js, jeps, B, R, cs, F, jnp.asarray(cond), key,
                                        n_composed=n_composed, sampling_timesteps=3)
    # the JAX step's unused DDIM noise is not replayed: the port does not draw it
    _, k0, k1 = jax.random.split(key, 3)
    K = n_composed + 1
    draws = Draws([_normal(k0, (K * B, R, F)), _normal(k1, (K * B, cs, F))])
    with torch.no_grad():
        t0, tst = tct.composing_time_sample(ts, teps, B, R, cs, F, torch.from_numpy(cond), draws,
                                            n_composed=n_composed, sampling_timesteps=3)
    assert not draws.arrays
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("kind,n_composed,cs", [("closed", 1, 1), ("closed", 2, 2), ("unet", 1, 1)])
def test_autoregress_time_compose_sample_matches(kind, n_composed, cs, unets):
    B, F = 2, 8
    R = 8 - cs
    js, ts = _schedules()
    jeps, teps = _eps(kind, unets)
    cond = np.random.default_rng(4).uniform(-1, 1, (B, cs, F)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jct.autoregress_time_compose_sample(js, jeps, B, R, cs, F, jnp.asarray(cond), key,
                                               n_composed=n_composed, sampling_timesteps=3)
    arrays = []
    for _ in range(n_composed + 1):
        key, k = jax.random.split(key)
        arrays += _ddim_draws(k, (B, R, F), 3)
    draws = Draws(arrays)
    with torch.no_grad():
        got = tct.autoregress_time_compose_sample(ts, teps, B, R, cs, F, torch.from_numpy(cond),
                                                  draws, n_composed=n_composed,
                                                  sampling_timesteps=3)
    assert not draws.arrays
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_bodies", [3, 4])
def test_classifier_free_compose_eps_matches(n_bodies):
    x = np.random.default_rng(6).uniform(-1, 1, (3, 8, n_bodies * 4)).astype(np.float32)
    t = np.array([0, 2, 5], np.int32)
    jf = jct.make_classifier_free_compose_eps(PAIR[0], UNCOND[0], n_bodies, coefficient=1.4)
    tf = tct.make_classifier_free_compose_eps(PAIR[1], UNCOND[1], n_bodies, coefficient=1.4)
    np.testing.assert_allclose(tf(torch.from_numpy(x), torch.from_numpy(t).long()).numpy(),
                               np.asarray(jf(jnp.asarray(x), jnp.asarray(t))), **TOL)


def test_classifier_free_compose_eps_matches_with_unets(unets):
    x = np.random.default_rng(7).uniform(-1, 1, (2, 8, 12)).astype(np.float32)
    t = np.array([1, 4], np.int32)
    jf = jax.jit(jct.make_classifier_free_compose_eps(unets["pair"][0], unets["uncond"][0], 3))
    tf = tct.make_classifier_free_compose_eps(unets["pair"][1], unets["uncond"][1], 3)
    with torch.no_grad():
        got = tf(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(x), jnp.asarray(t))), **TOL)


def _multibody_draws(key, shape, cond_shape, t_switch, inner, uhmc):
    """The draws of the ULA (inner = Langevin steps) or UHMC (inner =
    leapfrog steps) sampler, in the order the port asks for them."""
    if uhmc:
        key, k0, kv = jax.random.split(key, 3)
        out = [_normal(k0, (shape[0], shape[1] - cond_shape[1], shape[2])), _normal(kv, shape)]
    else:
        key, k0 = jax.random.split(key)
        out = [_normal(k0, (shape[0], shape[1] - cond_shape[1], shape[2]))]
    for t in range(T_STEPS - 1, -1, -1):
        key, k1, k2 = jax.random.split(key, 3)
        if t > t_switch:
            kk = k1
            for _ in range(inner):
                kk, k = jax.random.split(kk)
                out.append(_normal(k, shape))
        else:
            out.append(_normal(jax.random.split(k1)[0], shape))
        if cond_shape[1] > 0:
            out.append(_normal(k2, cond_shape))
    return out


def _cf_eps(kind, unets, n):
    pair = unets["pair"] if kind == "unet" else PAIR
    return (jct.make_classifier_free_compose_eps(pair[0], UNCOND[0], n),
            tct.make_classifier_free_compose_eps(pair[1], UNCOND[1], n))


@pytest.mark.parametrize("kind,cs", [("closed", 0), ("closed", 1), ("unet", 1)])
def test_sample_compose_multibodies_ula_matches(kind, cs, unets):
    n, B, H = 3, 2, 8
    js, ts = _schedules()
    jf, tf = _cf_eps(kind, unets, n)
    cond = np.random.default_rng(8).uniform(-1, 1, (B, max(cs, 1), n * 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(langevin_steps=2, t_switch=2, conditioned_steps=cs)
    want = jct.sample_compose_multibodies(js, jf, jnp.asarray(cond), H - cs, key, **kw)
    draws = Draws(_multibody_draws(key, (B, H, n * 4), (B, cs, n * 4), 2, 2, uhmc=False))
    got = tct.sample_compose_multibodies(ts, tf, torch.from_numpy(cond), H - cs, draws, **kw)
    assert not draws.arrays
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,cs", [("closed", 0), ("closed", 1), ("unet", 1)])
def test_sample_compose_multibodies_uhmc_matches(kind, cs, unets):
    n, B, H = 3, 2, 8
    js, ts = _schedules()
    jf, tf = _cf_eps(kind, unets, n)
    cond = np.random.default_rng(10).uniform(-1, 1, (B, max(cs, 1), n * 4)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(leapfrog_steps=2, t_switch=2, conditioned_steps=cs)
    want = jct.sample_compose_multibodies_uhmc(js, jf, jnp.asarray(cond), H - cs, key, **kw)
    draws = Draws(_multibody_draws(key, (B, H, n * 4), (B, cs, n * 4), 2, 2, uhmc=True))
    got = tct.sample_compose_multibodies_uhmc(ts, tf, torch.from_numpy(cond), H - cs, draws, **kw)
    assert not draws.arrays
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
