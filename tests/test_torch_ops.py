"""Parity of the port's plain kernel versions (ops/) with the JAX package's
references and its Pallas kernel, at the flagship denoiser's block shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish_reference as jax_cgm_reference
from cindm_tpu.ops.fused_rtb import fused_rtb as jax_fused_rtb
from cindm_tpu.ops.fused_rtb import fused_rtb_reference as jax_rtb_reference
from cindm_tpu_torch.ops import (
    _build,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_reference,
    fused_rtb,
    fused_rtb_reference,
    mish,
)

TOL = dict(rtol=1e-4, atol=1e-5)
K = 5
# (C_in, C_out, T) of the 16 ResidualTemporalBlocks of the flagship
# TemporalUnet1D(horizon 24, transition_dim 8, dim 64), then its head Conv1dBlock.
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
ARG_NAMES = ["w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]


def _rtb_args(C, O, B, T, seed, identity=None):
    """numpy inputs: x, temb and the block's parameters (wres None for identity)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    identity = (C == O) if identity is None else identity
    a = dict(
        x=f(B, T, C), temb=f(B, O),
        w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
        gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1),
        w2=f(K, O, O, scale=(K * O) ** -0.5), b2=f(O, scale=0.1),
        gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1),
        wres=None if identity else f(C, O, scale=C ** -0.5),
        bres=None if identity else f(O, scale=0.1),
    )
    return a


def _to(a, fn):
    return {k: None if v is None else fn(v) for k, v in a.items()}


@pytest.mark.parametrize("C,O,T", RTB_SHAPES, ids=[f"{c}-{o}-T{t}" for c, o, t in RTB_SHAPES])
def test_fused_rtb_reference_matches_jax(C, O, T):
    a = _rtb_args(C, O, 2, T, seed=C * 7 + O + T)
    want = np.asarray(jax_rtb_reference(**_to(a, jnp.asarray)))
    got = fused_rtb_reference(**_to(a, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


SHAPES_17 = [(C, O, T) for C, O, T in RTB_SHAPES] + [HEAD_SHAPE]


@pytest.mark.parametrize("C,O,T", SHAPES_17, ids=[f"{c}-{o}-T{t}" for c, o, t in SHAPES_17])
def test_conv1d_gn_mish_reference_matches_jax(C, O, T):
    a = _rtb_args(C, O, 2, T, seed=C + O * 3 + T)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    want = np.asarray(jax_cgm_reference(*map(jnp.asarray, args)))
    got = fused_conv1d_gn_mish_reference(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("C,O", [(128, 128), (128, 256)])
def test_fused_rtb_reference_matches_pallas_interpret(C, O):
    """Against the TPU kernel itself, run by Pallas's interpreter as
    tests/test_ops.py runs it."""
    a = _rtb_args(C, O, 2, 24, seed=11)
    want = np.asarray(jax_fused_rtb(**_to(a, jnp.asarray), batch_tile=2, interpret=True))
    got = fused_rtb_reference(**_to(a, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mish_matches_jax_including_extremes():
    x = np.concatenate([np.linspace(-30, 30, 601), [-1e4, -100.0, 100.0, 1e4]]).astype(np.float32)
    want = np.asarray(jnp.asarray(x) * jnp.tanh(jax.nn.softplus(jnp.asarray(x))))
    got = mish(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wrappers_use_plain_version_on_cpu_and_count_no_launch():
    a = _to(_rtb_args(16, 32, 3, 6, seed=5), torch.from_numpy)
    before = (fused_rtb.launches, fused_conv1d_gn_mish.launches)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), rtol=0, atol=0)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    torch.testing.assert_close(fused_conv1d_gn_mish(*args), fused_conv1d_gn_mish_reference(*args),
                               rtol=0, atol=0)
    assert (fused_rtb.launches, fused_conv1d_gn_mish.launches) == before


def _bad_inputs():
    a = _rtb_args(16, 32, 3, 6, seed=6)
    yield "float64", {**_to(a, torch.from_numpy), "x": torch.from_numpy(a["x"]).double()}, TypeError
    xt = torch.from_numpy(np.ascontiguousarray(a["x"].transpose(0, 2, 1))).transpose(1, 2)
    yield "non-contiguous", {**_to(a, torch.from_numpy), "x": xt}, ValueError
    yield "shape", {**_to(a, torch.from_numpy), "temb": torch.zeros(3, 16)}, ValueError
    yield "half-residual", {**_to(a, torch.from_numpy), "bres": None}, ValueError
    b = _rtb_args(16, 32, 3, 6, seed=7, identity=True)
    yield "identity-needs-C==O", _to(b, torch.from_numpy), ValueError
    yield "meta-device", _to(a, lambda v: torch.from_numpy(v).to("meta")), ValueError


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_fused_rtb_rejects_bad_inputs(case):
    _, kwargs, exc = case
    with pytest.raises(exc):
        fused_rtb(**kwargs)


def test_conv1d_gn_mish_rejects_groups_not_dividing_channels():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="groups"):
        fused_conv1d_gn_mish(x, torch.zeros(K, 8, 12), torch.zeros(12), torch.ones(12), torch.zeros(12))


def test_channel_rule_of_the_kernels():
    """The kernels read float4 rows, so a CUDA launch needs channel counts that
    are multiples of 4; the plain version on the CPU takes any count."""
    with pytest.raises(ValueError, match="C=6"):
        _build.check_channels("fused_rtb", C=6, O=16)
    _build.check_channels("fused_rtb", C=12, O=16)
    a = _to(_rtb_args(6, 16, 2, 5, seed=8), torch.from_numpy)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), rtol=0, atol=0)
