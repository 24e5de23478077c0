"""Parity of the port's sampling/ (composition, guidance, samplers) with
cindm_tpu.sampling, given the same eps-model and the same random draws.

The JAX samplers draw their noise from split PRNG keys; these tests make the
same splits with jax.random and hand the resulting draws, in the same order,
to the port's ``randn`` hook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.sampling import Diffusion1DConfig as JaxConfig
from cindm_tpu.sampling import guidance as jg
from cindm_tpu.sampling import sample as jax_sample
from cindm_tpu.sampling import sample_total_steps as jax_sample_total_steps
from cindm_tpu.sampling import sampler as js
from cindm_tpu.sampling.compose import make_composed_eps_model as jax_compose
from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.sampling import Diffusion1DConfig, sample, sample_total_steps
from cindm_tpu_torch.sampling import guidance as tg
from cindm_tpu_torch.sampling import sampler as ts
from cindm_tpu_torch.sampling.compose import make_composed_eps_model, resolve_fold_chunks

TOL = dict(rtol=1e-4, atol=1e-4)
N_BODIES, N_COMPOSED, CSS, SMS = 3, 1, 4, 8
T_TOT = SMS + N_COMPOSED * CSS
FEAT = N_BODIES * 4

_M = (np.random.default_rng(0).standard_normal((8, 8)) * 0.3).astype(np.float32)


def jax_base(x, t):
    """A fake 2-body eps-model, nonlinear in x and dependent on t."""
    return jnp.tanh(x @ _M + 0.01 * t[:, None, None].astype(jnp.float32))


def torch_base(x, t):
    return torch.tanh(x @ torch.from_numpy(_M) + 0.01 * t[:, None, None].float())


def _compose_kw(sched_j, sched_t, mode, clip):
    common = dict(compose_n_bodies=N_BODIES, n_composed=N_COMPOSED, compose_start_step=CSS,
                  single_model_step=SMS, compose_mode=mode, clip_pairwise_x_start=clip)
    return {**common, "sched": sched_j}, {**common, "sched": sched_t}


@pytest.mark.parametrize("fold_chunks", [0, 3])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("mode", ["mean-inside", "sum-inside"])
def test_composed_eps_model_matches(mode, clip, fold_chunks):
    B = 4  # folded axis 2 windows x 3 pairs x 4 = 24, divisible by 3
    jkw, tkw = _compose_kw(jax_make_schedule(20), make_schedule(20, device="cpu"), mode, clip)
    jm = jax_compose(jax_base, fold_chunks=fold_chunks, **jkw)
    tm = make_composed_eps_model(torch_base, fold_chunks=fold_chunks, **tkw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T_TOT, FEAT)).astype(np.float32)
    t = np.array([0, 5, 11, 19], np.int32)
    want = np.asarray(jm(jnp.asarray(x), jnp.asarray(t)))
    got = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_fold,requested,want", [
    (5376, 1, 1), (5376, 0, 1), (10752, 0, 2), (43008, 0, 8), (24, 3, 3), (24, 5, 1), (24, -1, 1),
])
def test_resolve_fold_chunks(n_fold, requested, want):
    assert resolve_fold_chunks(n_fold, requested) == want


def _design_fns(coef, tcc, mode):
    target = np.array([0.5, 0.4], np.float32)
    j = jg.get_design_fn(jnp.asarray(target), last_n_step=2, coef=jnp.asarray(coef) if
                         isinstance(coef, np.ndarray) else coef, time_consistency_coef=tcc,
                         design_fn_mode=mode, norm_factor=0.5)
    t = tg.get_design_fn(torch.from_numpy(target), last_n_step=2, coef=torch.from_numpy(coef) if
                         isinstance(coef, np.ndarray) else coef, time_consistency_coef=tcc,
                         design_fn_mode=mode, norm_factor=0.5)
    return j, t


@pytest.mark.parametrize("mode", ["L2", "L2square"])
@pytest.mark.parametrize("tcc", [0.0, 0.3])
@pytest.mark.parametrize("per_sample_coef", [False, True])
def test_design_fn_value_and_grad_match(mode, tcc, per_sample_coef):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (4, T_TOT, FEAT)).astype(np.float32)
    coef = rng.uniform(0.1, 2.0, 4).astype(np.float32) if per_sample_coef else 0.2
    jf, tf = _design_fns(coef, tcc, mode)
    want_v, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_v = tf(xt)
    got_g, = torch.autograd.grad(got_v, xt)
    np.testing.assert_allclose(float(got_v.detach()), float(want_v), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_eval_fns_and_ci_match():
    target = np.array([0.3, 0.7], np.float32)
    x = np.random.default_rng(3).uniform(-1, 1, (5, T_TOT, FEAT)).astype(np.float32)
    for last in (1, 3):
        np.testing.assert_allclose(
            float(tg.get_eval_fn(torch.from_numpy(target), last)(torch.from_numpy(x))),
            float(jg.get_eval_fn(jnp.asarray(target), last)(jnp.asarray(x))), rtol=1e-6)
        per_t = tg.get_eval_fn_per_sample(torch.from_numpy(target), last)(torch.from_numpy(x))
        per_j = jg.get_eval_fn_per_sample(jnp.asarray(target), last)(jnp.asarray(x))
        np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-6)
        np.testing.assert_allclose(float(tg.confidence_interval_95(per_t)),
                                   float(jg.confidence_interval_95(per_j)), rtol=1e-5)


@pytest.mark.parametrize("guidance", [
    "standard", "standard-alpha", "universal-forward", "universal-backward",
])
def test_guidance_grad_matches(guidance):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, T_TOT, FEAT)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (3, T_TOT, FEAT)).astype(np.float32)
    t = np.array([1, 8, 17], np.int32)
    jf, tf = _design_fns(0.2, 0.2, "L2")
    jspec = js.GuidanceSpec.parse(guidance, backward_steps=3, backward_lr=0.5)
    tspec = ts.GuidanceSpec.parse(guidance, backward_steps=3, backward_lr=0.5)
    assert (tspec.base, tspec.recurrence) == (jspec.base, jspec.recurrence)
    want = js._guidance_grad(jax_make_schedule(20), jspec, jf, jnp.asarray(x), jnp.asarray(x0),
                             jnp.asarray(t))
    got = ts._guidance_grad(make_schedule(20, device="cpu"), tspec, tf, torch.from_numpy(x),
                            torch.from_numpy(x0), torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_guidance_spec_parse():
    s = ts.GuidanceSpec.parse("universal-backward-recurrence-7", 4, 0.1)
    assert (s.base, s.recurrence, s.backward_steps, s.backward_lr) == ("universal-backward", 7, 4, 0.1)
    with pytest.raises(ValueError):
        ts.GuidanceSpec.parse("standard-recurrence")


class Draws:
    """Replays pre-made draws in order, checking each requested shape."""

    def __init__(self, arrays):
        self.arrays = [np.array(a) for a in arrays]

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)


def _step_draws(key, shape, rec):
    """jax.random draws of one p_sample_step: recurrence draws, then the noise."""
    out = []
    for _ in range(rec):
        key, k1 = jax.random.split(key)
        out.append(jax.random.normal(k1, shape, jnp.float32))
    if rec == 0:
        key, _ = jax.random.split(key)
    out.append(jax.random.normal(key, shape, jnp.float32))
    return out


def _loop_draws(key, shape, T, rec, cond_shape=None):
    """jax.random draws of p_sample_loop, in the order the port's loop asks."""
    key, k0 = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for _ in range(T):
        key, k1, k2 = jax.random.split(key, 3)
        out += _step_draws(k1, shape, rec)
        if cond_shape is not None:
            out.append(jax.random.normal(k2, cond_shape, jnp.float32))
    return out


@pytest.mark.parametrize("t", [0, 6])
@pytest.mark.parametrize("guidance", ["standard-recurrence-2", "universal-forward"])
def test_p_sample_step_matches_given_jax_draws(guidance, t):
    T = 10
    shape = (3, SMS, 8)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jf, tf = _design_fns(0.2, 0.2, "L2")
    jspec, tspec = js.GuidanceSpec.parse(guidance), ts.GuidanceSpec.parse(guidance)
    want_x, want_x0 = js.p_sample_step(jax_make_schedule(T), jax_base, jnp.asarray(x), t, key,
                                       design_fn=jf, guidance=jspec)
    draws = Draws(_step_draws(key, shape, tspec.recurrence))
    primes = [draws(shape) for _ in range(tspec.recurrence)]
    got_x, got_x0 = ts.p_sample_step(make_schedule(T, device="cpu"), torch_base,
                                     torch.from_numpy(x), t, draws(shape), primes,
                                     design_fn=tf, guidance=tspec)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), **TOL)


@pytest.mark.parametrize("with_cond", [False, True])
def test_p_sample_loop_matches_given_jax_draws(with_cond):
    """Three guided reverse steps with recurrence 2 over the composed 3-body model."""
    T = 3
    shape = (2, T_TOT, FEAT)
    jkw, tkw = _compose_kw(None, None, "mean-inside", False)
    jm, tm = jax_compose(jax_base, **jkw), make_composed_eps_model(torch_base, **tkw)
    jf, tf = _design_fns(0.2, 0.2, "L2")
    guidance = "standard-recurrence-2"
    cond = np.random.default_rng(6).uniform(-1, 1, (2, 2, FEAT)).astype(np.float32) if with_cond else None
    key = jax.random.PRNGKey(3)
    want = js.p_sample_loop(jax_make_schedule(T), jm, shape, key, design_fn=jf,
                            guidance=js.GuidanceSpec.parse(guidance),
                            cond=None if cond is None else jnp.asarray(cond))
    draws = Draws(_loop_draws(key, shape, T, 2, None if cond is None else cond.shape))
    got = ts.p_sample_loop(make_schedule(T, device="cpu"), tm, shape, draws, design_fn=tf,
                           guidance=ts.GuidanceSpec.parse(guidance),
                           cond=None if cond is None else torch.from_numpy(cond))
    assert not draws.arrays
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_cond", [False, True])
def test_ddim_sample_loop_matches_given_jax_draws(with_cond):
    T, steps = 10, 4
    shape = (2, SMS, 8)
    jf, tf = _design_fns(0.2, 0.0, "L2")
    cond = np.random.default_rng(8).uniform(-1, 1, (2, 2, 8)).astype(np.float32) if with_cond else None
    key = jax.random.PRNGKey(9)
    want = js.ddim_sample_loop(jax_make_schedule(T), jax_base, shape, key, sampling_timesteps=steps,
                               eta=0.5, design_fn=jf, guidance=js.GuidanceSpec.parse("standard"),
                               cond=None if cond is None else jnp.asarray(cond))
    k, k0 = jax.random.split(key)
    arrays = [jax.random.normal(k0, shape)]
    for _ in range(steps):
        k, k1, k2, _ = jax.random.split(k, 4)
        arrays.append(jax.random.normal(k1, shape, jnp.float32))
        if cond is not None:
            arrays.append(jax.random.normal(k2, cond.shape, jnp.float32))
    draws = Draws(arrays)
    got = ts.ddim_sample_loop(make_schedule(T, device="cpu"), torch_base, shape, draws,
                              sampling_timesteps=steps, eta=0.5, design_fn=tf,
                              guidance=ts.GuidanceSpec.parse("standard"),
                              cond=None if cond is None else torch.from_numpy(cond))
    assert not draws.arrays
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("compose_mode", ["mean-inside", "noise_sum"])
def test_sample_dispatcher_matches(compose_mode):
    T = 3
    jcfg, tcfg = JaxConfig(rollout_steps=SMS, timesteps=T), Diffusion1DConfig(rollout_steps=SMS, timesteps=T)
    kw = dict(batch_size=2, feature_size=FEAT, design_guidance="standard-recurrence-2",
              n_composed=N_COMPOSED, compose_start_step=CSS, compose_n_bodies=N_BODIES,
              compose_mode=compose_mode)
    jf, tf = _design_fns(0.2, 0.2, "L2")
    key = jax.random.PRNGKey(4)
    want = jax_sample(jcfg, jax_make_schedule(T), jax_base, key, design_fn=jf, **kw)
    draws = Draws(_loop_draws(key, (2, T_TOT, FEAT), T, 2))
    got = sample(tcfg, make_schedule(T, device="cpu"), torch_base, draws, design_fn=tf, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cond_steps,n_composed,n_bodies", [(0, 0, 2), (1, 0, 2), (0, 2, 8), (0, 0, 3)])
def test_sample_total_steps_matches(cond_steps, n_composed, n_bodies):
    j = JaxConfig(rollout_steps=23, conditioned_steps=cond_steps)
    t = Diffusion1DConfig(rollout_steps=23, conditioned_steps=cond_steps)
    assert sample_total_steps(t, n_composed, 4, n_bodies) == jax_sample_total_steps(j, n_composed, 4, n_bodies)
