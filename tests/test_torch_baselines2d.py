"""Parity of the port's 2D baselines with the JAX package: SpectralConv2d,
FNO2d and FNO1d against the JAX real-DFT form, LE-PDE's four submodules,
the whole model and ``lepde_loss`` (each <= 1e-5 of the JAX output's max
magnitude, with weights carried by ``params_from_flax`` and round-tripped
by ``flax_from_params``); the harness (parsing exact, losses <= 1e-6); and
CEM's population scoring, batched or through ``vmap``.

Inputs are channel-last numpy arrays from a seed; the port's models take
NCHW, so the tests transpose at the boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.baselines import fno as jf
from cindm_tpu.baselines import harness as jh
from cindm_tpu.baselines import lepde as jl
from cindm_tpu_torch.baselines import CEMConfig, cem_design
from cindm_tpu_torch.baselines import fno as tf
from cindm_tpu_torch.baselines import harness as th
from cindm_tpu_torch.baselines import lepde as tl
from cindm_tpu_torch.models import flax_from_params, params_from_flax
from cindm_tpu_torch.sampling.sampler import generator_randn
from torch_port_helpers import keystr_flat

TOL = 1e-5
HARNESS_TOL = 1e-6


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _load(tm, params):
    """JAX params into the port model, then back: the round trip is exact."""
    flat = keystr_flat(params["params"])
    tm.load_state_dict(params_from_flax(flat, tm))
    back = flax_from_params(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    return tm


def test_spectral_conv2d_matches():
    x = np.random.default_rng(0).standard_normal((2, 16, 12, 4)).astype(np.float32)
    jm = jf.SpectralConv2d(out_channels=3, modes1=4, modes2=5)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = tf.SpectralConv2d(4, 3, 4, 5, generator=torch.Generator())
    with torch.no_grad():
        for name in ("w_real", "w_imag"):
            getattr(tm, name).copy_(torch.from_numpy(np.array(params["params"][name])))
    assert _rel(nhwc(tm(nchw(x))), jm.apply(params, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("length,modes", [(24, 5), (8, 5)])
def test_spectral_conv1d_matches(length, modes):
    """At L = 8 the kept modes reach the Nyquist bin, which the inverse
    counts once, by its real part."""
    x = np.random.default_rng(length).standard_normal((2, length, 3)).astype(np.float32)
    jm = jf.SpectralConv1d(out_channels=2, modes=modes)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = tf.SpectralConv1d(3, 2, modes, generator=torch.Generator())
    with torch.no_grad():
        for name in ("w_real", "w_imag"):
            getattr(tm, name).copy_(torch.from_numpy(np.array(params["params"][name])))
    assert _rel(nhwc(tm(nchw(x))), jm.apply(params, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("n_layers", [1, 3])
def test_fno2d_matches(n_layers):
    x = np.random.default_rng(n_layers).standard_normal((2, 16, 16, 5)).astype(np.float32)
    jm = jf.FNO2d(out_channels=3, modes=4, width=8, n_layers=n_layers)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(tf.FNO2d(5, 3, modes=4, width=8, n_layers=n_layers), params)
    assert _rel(nhwc(tm(nchw(x))), jm.apply(params, jnp.asarray(x))) <= TOL


def test_fno1d_matches():
    x = np.random.default_rng(2).standard_normal((2, 24, 3)).astype(np.float32)
    jm = jf.FNO1d(out_channels=2, modes=5, width=8, n_layers=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(tf.FNO1d(3, 2, modes=5, width=8, n_layers=2), params)
    assert _rel(nhwc(tm(nchw(x))), jm.apply(params, jnp.asarray(x))) <= TOL


def test_fno_gelu_is_flax_tanh_form():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(tf.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)


LCFG = dict(latent_size=16, enc_dim=4, evo_hidden=16)
HW = 16


@pytest.fixture(scope="module")
def lepde():
    """One JAX LE-PDE (16 x 16), every output the tests compare, and the
    port model loaded from its weights."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    static = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    targets = rng.standard_normal((2, 3, HW, HW, 3)).astype(np.float32)
    jm = jl.LEPDE(jl.LEPDEConfig(**LCFG), out_hw=HW)
    params = jax.jit(lambda k: jm.init(k, u, static, 1))(jax.random.PRNGKey(2))
    ms = {1: 1.0, 3: 0.1}

    @jax.jit
    def outputs(p):
        z, zs = jm.apply(p, u, static, method=jm.encode)
        return {"encoder": z, "static_encoder": zs,
                "evolution": jm.apply(p, z, zs, method=lambda m, a, b: m.evolution(a, b)),
                "decoder": jm.apply(p, z, method=jm.decode),
                "model": jm.apply(p, u, static, 3),
                "loss": jl.lepde_loss(jm, p, u, static, targets),
                "loss_ms": jl.lepde_loss(jm, p, u, static, targets, multi_step_dict=ms,
                                         loss_type="l1")}

    want = jax.tree_util.tree_map(np.asarray, outputs(params))
    tm = _load(tl.LEPDE(tl.LEPDEConfig(**LCFG), out_hw=HW), params)
    return tm, (u, static, targets, ms), want


def test_lepde_submodules_match(lepde):
    tm, (u, static, _, _), want = lepde
    with torch.no_grad():
        z, zs = tm.encoder(nchw(u)), tm.static_encoder(nchw(static))
        got = {"encoder": z, "static_encoder": zs, "evolution": tm.evolution(z, zs),
               "decoder": tm.decoder(z).permute(0, 2, 3, 1)}
    for k, v in got.items():
        assert _rel(v.numpy(), want[k]) <= TOL, k


def test_lepde_model_and_loss_match(lepde):
    tm, (u, static, targets, ms), want = lepde
    tgt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(targets, -1, 2)))
    with torch.no_grad():
        out = tm(nchw(u), nchw(static), 3).permute(0, 1, 3, 4, 2).numpy()
        loss = float(tl.lepde_loss(tm, nchw(u), nchw(static), tgt))
        loss_ms = float(tl.lepde_loss(tm, nchw(u), nchw(static), tgt, multi_step_dict=ms,
                                      loss_type="l1"))
    assert _rel(out, want["model"]) <= TOL
    assert abs(loss - want["loss"]) <= TOL * abs(want["loss"])
    assert abs(loss_ms - want["loss_ms"]) <= TOL * abs(want["loss_ms"])


def test_lepde_flax_conventions():
    """SAME stride-2 pads 0 before and 1 after on an even size; stride 4
    from 64 pads nothing; the transposed conv doubles the size."""
    assert tl._same_pad(64, 3, 2) == (0, 1)
    assert tl._same_pad(64, 3, 4) == (0, 0) and tl._same_pad(16, 3, 4) == (0, 0)
    assert tl._same_pad(7, 3, 1) == (1, 1)
    m = tl.ConvTranspose2x(4, 2, generator=torch.Generator())
    assert m(torch.zeros(1, 4, 4, 4)).shape == (1, 2, 8, 8)


@pytest.mark.parametrize("spec", ["1", "4", "1^2:1e-2^4:1e-3", "2:0.5^3", "^1^"])
def test_parse_multi_step_matches(spec):
    assert th.parse_multi_step(spec) == jh.parse_multi_step(spec)


def test_parse_multi_step_rejects_empty():
    with pytest.raises(ValueError):
        th.parse_multi_step("^")


@pytest.mark.parametrize("loss_type", ["mse", "l1", "huber"])
def test_losses_match(loss_type):
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    targets = (2.0 * rng.standard_normal((2, 4, 3, 5))).astype(np.float32)
    pred = targets[:, 0] + rng.standard_normal((2, 3, 5)).astype(np.float32)
    want = float(jh.loss_core(jnp.asarray(pred), jnp.asarray(targets[:, 0]), loss_type))
    got = float(th.loss_core(torch.from_numpy(pred), torch.from_numpy(targets[:, 0]), loss_type))
    assert abs(got - want) <= HARNESS_TOL * abs(want)
    ms = {1: 1.0, 2: 1e-2, 4: 1e-3}
    want = float(jh.multi_step_loss(lambda c: 0.9 * c + 0.1, jnp.asarray(u0), jnp.asarray(targets),
                                    ms, loss_type))
    got = float(th.multi_step_loss(lambda c: 0.9 * c + 0.1, torch.from_numpy(u0),
                                   torch.from_numpy(targets), ms, loss_type))
    assert abs(got - want) <= HARNESS_TOL * abs(want)


def test_experiment_record_matches(tmp_path):
    import json

    args = {"algo": "fno", "lr": 1e-3, "epochs": 2}
    hist = [{"epoch": 0, "train_loss": 1.0, "val_loss": None}]
    a = th.experiment_record(str(tmp_path / "t"), args, hist, {"val_loss": None})
    b = jh.experiment_record(str(tmp_path / "j"), args, hist, {"val_loss": None})
    assert a.rsplit("/", 1)[1] == b.rsplit("/", 1)[1]
    with open(a) as fa, open(b) as fb:
        ja_, jb_ = json.load(fa), json.load(fb)
    assert set(ja_) == set(jb_) and ja_["history"] == jb_["history"] and ja_["args"] == jb_["args"]


def test_cem_batched_equals_vmap():
    """``batched=True`` scores the population in one call; the same draws
    give the same design as the vmap path."""
    target = torch.tensor([[0.3, -0.2, 0.7]])
    one = lambda c: (c - target).square().sum()
    cfg = CEMConfig(n_samples=16, n_elites=4, n_iterations=3)
    runs = []
    for batched, fn in ((False, one), (True, lambda pop: torch.stack([one(c) for c in pop]))):
        randn = generator_randn(torch.Generator().manual_seed(0), torch.device("cpu"))
        runs.append(cem_design(cfg, lambda c: c, fn, (1, 3), randn, clamp_fn=lambda c: c,
                               batched=batched))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=0, atol=0)
