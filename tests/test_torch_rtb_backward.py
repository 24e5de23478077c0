"""The closed-form backward of the fused ResidualTemporalBlock and of the head
Conv1d+GN+Mish (``fused_rtb_backward_reference``,
``fused_conv1d_gn_mish_backward_reference``), held on the CPU to the JAX
package's custom VJP and to torch autograd of the plain forward.

They are the plain versions of the CUDA backward kernels
(``csrc/block_backward.cu``), which compute the same cotangents from what the
forward's saving instance keeps (h, z1, z2 and both GroupNorms' mean and
rstd), so the saving forward's plain version is held here too. The kernels
themselves are held against these closed forms on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish_reference as jax_cgm_reference
from cindm_tpu.ops.fused_rtb import fused_rtb_differentiable as jax_rtb_differentiable
from cindm_tpu_torch.ops import (
    FusedConv1dGNMish,
    FusedRTB,
    fused_conv1d_gn_mish_backward_reference,
    fused_conv1d_gn_mish_forward_saving_reference,
    fused_conv1d_gn_mish_reference,
    fused_rtb_backward_reference,
    fused_rtb_forward_saving_reference,
    fused_rtb_reference,
    mish,
)
from cindm_tpu_torch.ops.fused_conv_gn import (
    conv1d_dgrad,
    conv1d_same,
    conv1d_wgrad,
    group_norm,
    mish_grad,
)
from torch_port_helpers import tf32_split

K = 5
# fp32 gradients of the same function in another order of operations (as
# tests/test_torch_vjp.py states)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RTB_NAMES = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
HEAD_NAMES = ["x", "w", "b", "gn_scale", "gn_bias"]
# (C_in, C_out, T) of the 16 ResidualTemporalBlocks of TemporalUnet1D(horizon
# 24, transition_dim 8, dim 64), in call order
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
SMALL = [(16, 32, 24), (32, 32, 12), (8, 16, 3), (24, 24, 6)]
SMALL_IDS = ["proj-T24", "identity-T12", "proj-T3", "identity-T6"]


def _rtb_inputs(C, O, B, T, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(K, O, O, scale=(K * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    if C != O:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    return a, f(B, T, O)


def _torch_args(a):
    return [None if a.get(n) is None else torch.from_numpy(a[n]) for n in RTB_NAMES]


def _saved(args):
    return args + list(fused_rtb_forward_saving_reference(*args)[1:])


@pytest.mark.parametrize("C,O,T", SMALL, ids=SMALL_IDS)
def test_rtb_closed_form_matches_jax_custom_vjp(C, O, T):
    a, g = _rtb_inputs(C, O, 3, T, seed=C * O + T + 1)
    names = [n for n in RTB_NAMES if n in a]
    _, vjp = jax.vjp(lambda *v: jax_rtb_differentiable(*v), *(jnp.asarray(a[n]) for n in names))
    want = dict(zip(names, vjp(jnp.asarray(g))))
    args = _torch_args(a)
    got = fused_rtb_backward_reference(_saved(args), torch.from_numpy(g), [t is not None for t in args])
    for n, gt in zip(RTB_NAMES, got):
        if n not in a:
            assert gt is None, n
        else:
            np.testing.assert_allclose(gt.numpy(), np.asarray(want[n]), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("T", [24, 12, 6, 3])
def test_head_closed_form_matches_jax_vjp(T):
    a, _ = _rtb_inputs(16, 24, 3, T, seed=T)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    g = np.random.default_rng(T + 1).standard_normal((3, T, 24)).astype(np.float32)
    _, vjp = jax.vjp(jax_cgm_reference, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(v) for v in args]
    saved = ts + list(fused_conv1d_gn_mish_forward_saving_reference(*ts)[1:])
    got = fused_conv1d_gn_mish_backward_reference(saved, torch.from_numpy(g), [True] * 5)
    for n, gt, gj in zip(HEAD_NAMES, got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("C,O,T", RTB_SHAPES, ids=[f"{i}:{c}-{o}-T{t}" for i, (c, o, t) in enumerate(RTB_SHAPES)])
def test_rtb_closed_form_matches_autograd_at_every_denoiser_shape(C, O, T):
    """All 16 blocks of the flagship denoiser at batch 2: the closed form
    against torch autograd through fused_rtb_reference."""
    i = RTB_SHAPES.index((C, O, T))
    a, g = _rtb_inputs(C, O, 2, T, seed=100 + i)
    args = _torch_args(a)
    ts = [None if t is None else t.clone().requires_grad_(True) for t in args]
    out = fused_rtb_reference(*ts)
    want = torch.autograd.grad(out, [t for t in ts if t is not None], torch.from_numpy(g))
    got = fused_rtb_backward_reference(_saved(args), torch.from_numpy(g), [t is not None for t in args])
    want = iter(want)
    for n, gt, t in zip(RTB_NAMES, got, args):
        if t is None:
            assert gt is None, n
            continue
        gw = next(want)
        np.testing.assert_allclose(gt.numpy(), gw.numpy(), err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("C,O,T", SMALL, ids=SMALL_IDS)
def test_saving_forward_keeps_what_group_norm_computes(C, O, T):
    """The saving forward's out is fused_rtb_reference's bit for bit; h, z1,
    z2 and both GroupNorms' mean and rstd are what conv1d_same and
    group_norm's own arithmetic give."""
    a, _ = _rtb_inputs(C, O, 3, T, seed=T + 7)
    args = _torch_args(a)
    x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres = args
    out, h, z1, z2, mean1, rstd1, mean2, rstd2 = fused_rtb_forward_saving_reference(*args)
    torch.testing.assert_close(out, fused_rtb_reference(*args), rtol=0, atol=0)
    torch.testing.assert_close(z1, conv1d_same(x, w1, b1), rtol=0, atol=0)
    torch.testing.assert_close(z2, conv1d_same(h, w2, b2), rtol=0, atol=0)
    for z, mean, rstd, gs, gb in ((z1, mean1, rstd1, gs1, gb1), (z2, mean2, rstd2, gs2, gb2)):
        assert mean.shape == rstd.shape == (3, 8)
        zg = z.reshape(3, T, 8, O // 8).double()
        np.testing.assert_allclose(mean.numpy(), zg.mean(dim=(1, 3)).numpy(), rtol=1e-5, atol=1e-6)
        var = zg.var(dim=(1, 3), unbiased=False)
        np.testing.assert_allclose(rstd.numpy(), (var + 1e-5).rsqrt().numpy(), rtol=1e-5)
        yh = ((z.reshape(3, T, 8, O // 8) - mean[:, None, :, None])
              * rstd[:, None, :, None]).reshape(3, T, O)
        torch.testing.assert_close(yh * gs + gb, group_norm(z, gs, gb, 8, 1e-5), rtol=0, atol=0)
    hw = fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1) + temb[:, None, :]
    torch.testing.assert_close(h, hw, rtol=0, atol=0)
    head = fused_conv1d_gn_mish_forward_saving_reference(x, w1, b1, gs1, gb1)
    torch.testing.assert_close(head[0], fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1),
                               rtol=0, atol=0)
    for got, want in zip(head[1:], (z1, mean1, rstd1)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mish_grad_is_the_derivative_of_mish():
    y = torch.linspace(-30, 30, 6001, dtype=torch.float64).requires_grad_(True)
    want, = torch.autograd.grad(mish(y).sum(), y)
    np.testing.assert_allclose(mish_grad(y.detach()).numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    y32 = torch.tensor([-1e4, -100.0, 0.0, 100.0, 1e4])
    assert bool(torch.isfinite(mish_grad(y32)).all())


@pytest.mark.parametrize("wanted", [("x",), ("temb",), ("w1", "gs2"), ("wres", "bres"),
                                    ("b1", "b2", "gb1"), tuple(RTB_NAMES[1:])],
                         ids=lambda w: "+".join(w))
def test_needs_input_grad_masking(wanted):
    """Through FusedRTB on CPU tensors: exactly the inputs that require grad
    get one, equal to the closed form's, and torch.autograd.grad sees None
    nowhere else."""
    a, g = _rtb_inputs(16, 32, 2, 6, seed=len(wanted))
    args = _torch_args(a)
    ts = [t.clone().requires_grad_(n in wanted) for n, t in zip(RTB_NAMES, args)]
    out = FusedRTB.apply(*ts, 8, 1e-5)
    req = [t for t in ts if t.requires_grad]
    got = dict(zip([n for n in RTB_NAMES if n in wanted], torch.autograd.grad(out, req, torch.from_numpy(g))))
    needs = [n in wanted for n in RTB_NAMES]
    closed = fused_rtb_backward_reference(_saved(args), torch.from_numpy(g), needs)
    for n, c in zip(RTB_NAMES, closed):
        if n in wanted:
            torch.testing.assert_close(got[n], c, rtol=0, atol=0, msg=n)
        else:
            assert c is None, n


@pytest.mark.parametrize("needs", [[True] * 5, [False, True, True, True, True],
                                   [False, False, False, True, False], [True, False, False, False, False]],
                         ids=["all", "no-x", "gn_scale", "x"])
def test_head_needs_input_grad_masking(needs):
    a, _ = _rtb_inputs(16, 24, 2, 12, seed=3)
    ts = [torch.from_numpy(a[n]).requires_grad_(w)
          for n, w in zip(["x", "w1", "b1", "gs1", "gb1"], needs)]
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 24)).astype(np.float32))
    out = FusedConv1dGNMish.apply(*ts, 8, 1e-5)
    got = torch.autograd.grad(out, [t for t in ts if t.requires_grad], g)
    saved = [t.detach() for t in ts]
    closed = fused_conv1d_gn_mish_backward_reference(
        saved + list(fused_conv1d_gn_mish_forward_saving_reference(*saved)[1:]), g, needs)
    got = iter(got)
    for n, want, c in zip(HEAD_NAMES, needs, closed):
        assert (c is None) == (not want), n
        if want:
            torch.testing.assert_close(next(got), c, rtol=0, atol=0, msg=n)


def _conv_3xtf32(x, w):
    """conv1d_same without bias with every product a*w taken as
    small(a)*big(w) + big(a)*small(w) + big(a)*big(w), as the stage kernel's
    main loop (and with it the dgrad stages) multiplies. numpy in, torch out."""
    (xb, xs), (wb, ws) = tf32_split(x), tf32_split(w)
    t = torch.from_numpy
    return (conv1d_same(t(xs), t(wb), None) + conv1d_same(t(xb), t(ws), None)
            + conv1d_same(t(xb), t(wb), None))


@pytest.mark.parametrize("T", [3, 6, 12, 24])
def test_3xtf32_dgrad_and_wgrad_match_the_closed_form(T):
    """The backward kernels' GEMMs in 3xTF32 (the dgrad as a conv with the
    flipped, transposed weights; the wgrad as products of split operands)
    agree with the fp32 closed form within 1e-4 of its largest entry, and
    single-pass TF32 would not."""
    rng = np.random.default_rng(T)
    C, O, B = 48, 64, 6
    dz = rng.standard_normal((B, T, O)).astype(np.float32)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C, O)) / np.sqrt(K * C)).astype(np.float32)
    want_dx = conv1d_dgrad(torch.from_numpy(dz), torch.from_numpy(w)).numpy()
    got_dx = _conv_3xtf32(dz, np.ascontiguousarray(np.flip(w, 0).transpose(0, 2, 1))).numpy()
    want_dw = conv1d_wgrad(torch.from_numpy(x), torch.from_numpy(dz), K).numpy()
    (xb, xs), (db, ds) = tf32_split(x), tf32_split(dz)
    t = torch.from_numpy
    got_dw = sum(conv1d_wgrad(t(p), t(q), K).numpy() for p, q in ((xs, db), (xb, ds), (xb, db)))
    one_pass = conv1d_wgrad(t(xb), t(db), K).numpy()
    for got, want in ((got_dx, want_dx), (got_dw, want_dw)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(one_pass - want_dw).max() > 10 * np.abs(got_dw - want_dw).max()

