"""Parity of the port's core/ (schedules, DDPM math) with cindm_tpu.core."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.core import diffusion as jdd
from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu_torch.core import diffusion as tdd
from cindm_tpu_torch.core import make_schedule

TOL = dict(rtol=1e-6, atol=1e-6)
FIELDS = [
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2", "snr",
    "sqrt_alpha_ratio", "sqrt_one_minus_alpha_ratio", "backward_delta_coef", "guidance_eta",
]


@pytest.mark.parametrize("timesteps", [50, 1000])
@pytest.mark.parametrize("name", ["linear", "cosine", "sigmoid"])
def test_schedule_buffers_match(name, timesteps):
    js = jax_make_schedule(timesteps, name)
    ts = make_schedule(timesteps, name, device="cpu")
    assert ts.num_timesteps == js.num_timesteps == timesteps
    for f in FIELDS:
        got = getattr(ts, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, f)), **TOL, err_msg=f)


def test_make_schedule_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_schedule(10, device="cuda")


T = 50
B = 4
SHAPE = (B, 6, 8)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(SHAPE).astype(np.float32)
    b = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 7, 31, T - 1], dtype=np.int32)
    return a, b, t


def _both(fn_name, a, b, t, **kw):
    js = jax_make_schedule(T)
    ts = make_schedule(T, device="cpu")
    jout = getattr(jdd, fn_name)(js, jnp.asarray(a), jnp.asarray(t), jnp.asarray(b), **kw) \
        if fn_name != "q_posterior" else jdd.q_posterior(js, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    tt = torch.from_numpy(t).long()
    tout = getattr(tdd, fn_name)(ts, torch.from_numpy(a), tt, torch.from_numpy(b), **kw) \
        if fn_name != "q_posterior" else tdd.q_posterior(ts, torch.from_numpy(a), torch.from_numpy(b), tt)
    return jout, tout


@pytest.mark.parametrize("fn_name", [
    "q_sample", "predict_start_from_noise", "predict_noise_from_start",
    "predict_v", "predict_start_from_v",
])
def test_diffusion_function_matches(fn_name):
    a, b, t = _inputs(0)
    jout, tout = _both(fn_name, a, b, t)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_q_posterior_matches():
    a, b, t = _inputs(1)
    jout, tout = _both("q_posterior", a, b, t)
    for j, g in zip(jout, tout):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(j), g.shape), **TOL)


def test_extract_matches():
    js, ts = jax_make_schedule(T), make_schedule(T, device="cpu")
    t = np.array([3, 0, 49], np.int32)
    got = tdd.extract(ts.betas, torch.from_numpy(t).long(), 4)
    want = jdd.extract(js.betas, jnp.asarray(t), 4)
    assert got.shape == want.shape == (3, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("clip,rederive", [(False, False), (True, False), (True, True)])
def test_model_prediction_from_output_matches(objective, clip, rederive):
    a, b, t = _inputs(2)
    js, ts = jax_make_schedule(T), make_schedule(T, device="cpu")
    j = jdd.model_prediction_from_output(js, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t),
                                         objective, clip, rederive)
    g = tdd.model_prediction_from_output(ts, torch.from_numpy(a), torch.from_numpy(b),
                                         torch.from_numpy(t).long(), objective, clip, rederive)
    for jj, gg in zip(j, g):
        np.testing.assert_allclose(gg.numpy(), np.asarray(jj), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n,s", [(1000, 50), (1000, 1000), (100, 7)])
def test_ddim_times_match(n, s):
    jt, jn = jdd.ddim_times(n, s)
    tt, tn = tdd.ddim_times(n, s)
    assert tt == np.asarray(jt).tolist() and tn == np.asarray(jn).tolist()
