"""The port's differentiable kernel wrappers (ops.FusedRTB,
ops.FusedConv1dGNMish) and the training loss through TemporalUnet1D, against
the JAX package's custom VJP and jax.value_and_grad of its p_losses.

On the CPU the Functions' forward is the plain version and their backward the
recompute the card also runs, so these tests hold the VJP's arithmetic; the
kernel forward is held against it on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish_reference as jax_cgm_reference
from cindm_tpu.ops.fused_rtb import fused_rtb_differentiable as jax_rtb_differentiable
from cindm_tpu.sampling.diffusion1d import Diffusion1DConfig as JaxConfig
from cindm_tpu.sampling.diffusion1d import p_losses as jax_p_losses
from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.models.blocks import ResidualTemporalBlock
from cindm_tpu_torch.ops import (
    FusedConv1dGNMish,
    FusedRTB,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_differentiable,
    fused_rtb,
    fused_rtb_differentiable,
    fused_rtb_reference,
)
from cindm_tpu_torch.sampling import Diffusion1DConfig, p_losses
from torch_port_helpers import flax_grads, flax_params, keystr_flat, port_model

K = 5
# fp32 gradients of the same function in another order of operations
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RTB_NAMES = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]


def _rtb_inputs(C, O, B, T, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(K, O, O, scale=(K * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    if C != O:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    return a, f(B, T, O)


@pytest.mark.parametrize("C,O,T", [(16, 32, 24), (32, 32, 12), (8, 16, 3), (24, 24, 6)],
                         ids=["proj-T24", "identity-T12", "proj-T3", "identity-T6"])
def test_fused_rtb_vjp_matches_jax_custom_vjp(C, O, T):
    a, g = _rtb_inputs(C, O, 3, T, seed=C * O + T)
    names = [n for n in RTB_NAMES if n in a]
    want_out, vjp = jax.vjp(lambda *v: jax_rtb_differentiable(*v), *(jnp.asarray(a[n]) for n in names))
    want = vjp(jnp.asarray(g))
    ts = {n: torch.from_numpy(a[n]).requires_grad_(True) for n in names}
    out = fused_rtb_differentiable(**ts)
    assert out.grad_fn is not None and "FusedRTB" in out.grad_fn.name()
    got = torch.autograd.grad(out, [ts[n] for n in names], torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **GRAD_TOL)
    for n, gt, gj in zip(names, got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), err_msg=n, **GRAD_TOL)


def test_fused_conv1d_gn_mish_vjp_matches_jax():
    a, _ = _rtb_inputs(16, 24, 3, 24, seed=4)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    g = np.random.default_rng(5).standard_normal((3, 24, 24)).astype(np.float32)
    _, vjp = jax.vjp(jax_cgm_reference, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in args]
    out = fused_conv1d_gn_mish_differentiable(*ts)
    assert "FusedConv1dGNMish" in out.grad_fn.name()
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for i, (gt, gj) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), err_msg=str(i), **GRAD_TOL)


def test_function_returns_grads_only_where_needed():
    """Only the inputs that require grad get one (the identity block passes
    no residual: its two slots stay None), equal to plain autograd's."""
    a, g = _rtb_inputs(8, 8, 2, 6, seed=6)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    w1 = ts["w1"].clone().requires_grad_(True)
    out = FusedRTB.apply(*({**ts, "w1": w1}.get(n) for n in RTB_NAMES), 8, 1e-5)
    out.backward(torch.from_numpy(g))
    want, = torch.autograd.grad(fused_rtb_reference(**{**ts, "w1": w1}), w1, torch.from_numpy(g))
    assert ts["x"].grad is None
    torch.testing.assert_close(w1.grad, want, rtol=0, atol=0)


def test_raw_wrappers_refuse_a_gradient():
    """Their output has no autograd history, so a gradient would vanish."""
    a, _ = _rtb_inputs(16, 32, 2, 6, seed=7)
    ts = {n: torch.from_numpy(v) for n, v in a.items()}
    ts["gs2"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_rtb_differentiable"):
        fused_rtb(**ts)
    head = [ts["x"].clone().requires_grad_(True), ts["w1"], ts["b1"], ts["gs1"], ts["gb1"]]
    with pytest.raises(RuntimeError, match="fused_conv1d_gn_mish_differentiable"):
        fused_conv1d_gn_mish(*head)
    with torch.no_grad():
        torch.testing.assert_close(fused_rtb(**ts), fused_rtb_reference(**ts), rtol=0, atol=0)
        fused_conv1d_gn_mish(*head)


def test_cpu_backward_counts_nothing():
    before = (FusedRTB.launches, FusedRTB.backwards, FusedConv1dGNMish.backwards,
              fused_rtb.launches, fused_conv1d_gn_mish.launches)
    m = port_model(dim=8, seed=1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 24, 8)).astype(np.float32))
    m(x, torch.tensor([3, 9])).square().mean().backward()
    assert (FusedRTB.launches, FusedRTB.backwards, FusedConv1dGNMish.backwards,
            fused_rtb.launches, fused_conv1d_gn_mish.launches) == before


def test_residual_weight_gradient_reaches_the_parameter():
    """wres enters the block as the view residual.weight[0]; its gradient
    must land in the [1, C, O] parameter, equal to the plain path's."""
    blk = ResidualTemporalBlock(16, 32, 8, generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    temb = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    grads = []
    for use_kernels in (True, False):
        blk.zero_grad()
        blk(x, temb, use_kernels).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in blk.named_parameters()})
    assert grads[0]["residual.weight"].shape == (1, 16, 32)
    assert float(grads[0]["residual.weight"].abs().max()) > 0
    for n in grads[1]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=0, msg=n)


@pytest.fixture(scope="module")
def jax_loss_and_grad():
    """jax.value_and_grad of the JAX package's p_losses through model.apply,
    one compile per conditioned_steps."""
    jm = JaxUnet(horizon=24, transition_dim=8, dim=16)
    fns = {}

    def get(cond_steps):
        if cond_steps not in fns:
            cfg = JaxConfig(rollout_steps=24 - cond_steps, conditioned_steps=cond_steps,
                            timesteps=100)
            sched = jax_make_schedule(100, "cosine")
            fns[cond_steps] = jax.jit(jax.value_and_grad(
                lambda p, x, c, k: jax_p_losses(cfg, sched, lambda a, t: jm.apply(p, a, t), x, c, k)))
        return fns[cond_steps]

    return get


@pytest.mark.parametrize("cond_steps", [0, 1])
def test_p_losses_and_grads_match_jax(jax_loss_and_grad, cond_steps):
    """The port's loss and every parameter's gradient through the kernel
    path (TemporalUnet1D(use_kernels=True)) against JAX, fed JAX's own t and
    noise draws."""
    m = port_model(dim=16, seed=10 + cond_steps)
    rng = np.random.default_rng(cond_steps)
    B, R = 4, 24 - cond_steps
    x = (0.5 * rng.standard_normal((B, R, 8))).astype(np.float32)
    cond = (0.5 * rng.standard_normal((B, cond_steps, 8))).astype(np.float32) if cond_steps else None
    key = jax.random.PRNGKey(7 + cond_steps)
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (B,), 0, 100))
    noise = np.array(jax.random.normal(kn, x.shape, jnp.float32))
    want_loss, want_grads = jax_loss_and_grad(cond_steps)(
        flax_params(m), x, None if cond is None else jnp.asarray(cond), key)

    cfg = Diffusion1DConfig(rollout_steps=R, conditioned_steps=cond_steps, timesteps=100)
    sched = make_schedule(100, device="cpu")
    loss = p_losses(cfg, sched, lambda a, tt: m(a, tt, use_kernels=True), torch.from_numpy(x),
                    None if cond is None else torch.from_numpy(cond),
                    t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, list(m.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = flax_grads(m, grads)
    want = keystr_flat(want_grads["params"])
    assert set(got) == set(want)
    for k in want:
        # each gradient within 1e-4 of its largest entry (fp32, 16 chained blocks)
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4 * scale, err_msg=k)
