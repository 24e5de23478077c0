"""Parity of the port's generic Unet1D and its attention blocks with
cindm_tpu.models.unet1d_generic / cindm_tpu.models.blocks, on the same
weights (moved as numpy arrays) and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.models import blocks as jblocks
from cindm_tpu.models.unet1d_generic import Unet1D as JaxUnet1D
from cindm_tpu_torch.models import Unet1D, params_from_flax
from cindm_tpu_torch.models import blocks as tblocks
from torch_port_helpers import flax_grads, flax_params, keystr_flat

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("features", ["sinusoidal", "learned", "random"])
def test_unet1d_matches(features):
    kw = {"learned": dict(learned_sinusoidal_cond=True),
          "random": dict(random_fourier_features=True)}.get(features, {})
    tm = Unet1D(8, channels=3, dim_mults=(1, 2), **kw, generator=torch.Generator().manual_seed(1))
    jm = JaxUnet1D(dim=8, channels=3, dim_mults=(1, 2), **kw)
    params = flax_params(tm)
    back = params_from_flax(keystr_flat(params), tm)
    assert set(back) == set(tm.state_dict())
    x = np.random.default_rng(0).standard_normal((2, 16, 3)).astype(np.float32)
    t = np.array([3, 17], np.int32)

    def loss(p, x):
        return jnp.sum(jm.apply(p, x, jnp.asarray(t)) ** 2)

    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
    want_g = keystr_flat(jax.jit(jax.grad(loss))(params, jnp.asarray(x))["params"])
    out = tm(torch.from_numpy(x), torch.from_numpy(t).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    params_t = list(tm.parameters())
    wrt = [p for p in params_t if p.requires_grad]
    grads = dict(zip(map(id, wrt), torch.autograd.grad(out.square().sum(), wrt)))
    got_g = flax_grads(tm, [grads.get(id(p), torch.zeros_like(p)) for p in params_t])
    for name, g in got_g.items():
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    if features == "random":  # the random features take no gradient, as under stop_gradient
        assert not tm.time_pos.weights.requires_grad
        assert not np.any(want_g["['RandomOrLearnedSinusoidalPosEmb_0']['weights']"])


def _attention(kind, dim):
    jcls = {"linear": jblocks.LinearAttention, "full": jblocks.FullAttention}[kind]
    tcls = {"linear": tblocks.LinearAttention, "full": tblocks.FullAttention}[kind]
    return jcls(dim), tcls(dim, generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_attention_blocks_match(kind):
    jm, tm = _attention(kind, 12)
    x = np.random.default_rng(3).standard_normal((2, 10, 12)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    sd = {"qkv.weight": params["Dense_0"]["Dense_0"]["kernel"],
          "out.weight": params["Dense_1"]["Dense_0"]["kernel"],
          "out.bias": params["Dense_1"]["Dense_0"]["bias"]}
    if kind == "linear":
        sd["norm.g"] = params["ChannelLayerNorm_0"]["g"] * 1.5
        params = {**params, "ChannelLayerNorm_0": {"g": sd["norm.g"]}}
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_random_or_learned_sinusoidal_pos_emb_matches():
    jm = jblocks.RandomOrLearnedSinusoidalPosEmb(16)
    t = np.array([0, 7, 999], np.int32)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(t))
    tm = tblocks.RandomOrLearnedSinusoidalPosEmb(16, generator=torch.Generator())
    tm.load_state_dict({"weights": torch.from_numpy(np.asarray(params["params"]["weights"]))})
    with torch.no_grad():
        got = tm(torch.from_numpy(t))
    assert got.shape == (3, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(t))), **TOL)
