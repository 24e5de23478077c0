"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no GPU is present. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.models import TemporalUnet1D
from cindm_tpu_torch.ops import (
    FusedConv1dGNMish,
    FusedRTB,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_differentiable,
    fused_conv1d_gn_mish_reference,
    fused_rtb,
    fused_rtb_differentiable,
    fused_rtb_reference,
)
from cindm_tpu_torch.sampling import Diffusion1DConfig, p_losses

pytestmark = pytest.mark.cuda

K = 5
TOL = dict(rtol=1e-4, atol=1e-4)
# (C_in, C_out, T): the flagship denoiser's block shapes, plus a few odd ones
# (a 3-body stem with 12 channels, a ragged last tile, a long horizon)
SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12), (128, 256, 6), (256, 256, 6),
    (256, 512, 3), (512, 512, 3), (1024, 512, 3), (512, 256, 3), (512, 256, 6),
    (256, 128, 6), (256, 128, 12), (128, 64, 12),
    (12, 16, 5), (24, 24, 7), (16, 40, 48),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(C, O, B, T, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    a = dict(x=r(B, T, C), temb=r(B, O), w1=r(K, C, O, scale=(K * C) ** -0.5), b1=r(O, scale=0.1),
             gs1=1 + r(O, scale=0.1), gb1=r(O, scale=0.1), w2=r(K, O, O, scale=(K * O) ** -0.5),
             b2=r(O, scale=0.1), gs2=1 + r(O, scale=0.1), gb2=r(O, scale=0.1))
    if C != O:
        a.update(wres=r(C, O, scale=C ** -0.5), bres=r(O, scale=0.1))
    return a


@pytest.mark.parametrize("C,O,T", SHAPES, ids=lambda v: str(v))
def test_fused_rtb_kernel_matches_plain(dev, C, O, T):
    a = _args(C, O, 37, T, dev, seed=C + O + T)
    n = fused_rtb.launches
    got = fused_rtb(**a)
    torch.cuda.synchronize()
    assert fused_rtb.launches == n + 1
    torch.testing.assert_close(got, fused_rtb_reference(**a), **TOL)


@pytest.mark.parametrize("C,O,T", SHAPES, ids=lambda v: str(v))
def test_fused_conv1d_gn_mish_kernel_matches_plain(dev, C, O, T):
    a = _args(C, O, 37, T, dev, seed=C * O + T)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    n = fused_conv1d_gn_mish.launches
    got = fused_conv1d_gn_mish(*args)
    torch.cuda.synchronize()
    assert fused_conv1d_gn_mish.launches == n + 1
    torch.testing.assert_close(got, fused_conv1d_gn_mish_reference(*args), **TOL)


@pytest.mark.parametrize("C,O,T", [(512, 512, 3), (256, 128, 6), (64, 64, 24)], ids=lambda v: str(v))
def test_fused_rtb_small_batch_matches_plain(dev, C, O, T):
    """Two samples: a tile of 192 rows holds 2 of its 192/T samples, and
    every other row of the tile is absent."""
    a = _args(C, O, 2, T, dev, seed=C + T)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)


# per flagship T, a block with the identity residual and one with the 1x1
# projection; ragged batches leave the last tile of 192/T samples partly empty
RAGGED_SHAPES = [(512, 512, 3), (1024, 512, 3), (256, 256, 6), (128, 256, 6),
                 (128, 128, 12), (64, 128, 12), (64, 64, 24), (8, 64, 24)]


@pytest.mark.parametrize("B", [1, 5, 500, 5375], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,O,T", RAGGED_SHAPES, ids=lambda v: str(v))
def test_fused_rtb_ragged_batch_matches_plain(dev, C, O, T, B):
    a = _args(C, O, B, T, dev, seed=C + O + T + B)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)


@pytest.mark.parametrize("B", [1, 5, 500, 5375], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,O,T", RAGGED_SHAPES, ids=lambda v: str(v))
def test_fused_conv1d_gn_mish_ragged_batch_matches_plain(dev, C, O, T, B):
    a = _args(C, O, B, T, dev, seed=C * O + T + B)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    torch.testing.assert_close(fused_conv1d_gn_mish(*args), fused_conv1d_gn_mish_reference(*args),
                               **TOL)


def test_kernels_reject_mixed_devices(dev):
    a = _args(16, 32, 3, 6, dev, seed=1)
    a["w1"] = a["w1"].cpu()
    with pytest.raises(ValueError, match="w1"):
        fused_rtb(**a)


def test_kernels_reject_channels_not_a_multiple_of_4(dev):
    a = _args(6, 16, 3, 5, dev, seed=2)
    with pytest.raises(ValueError, match="C=6"):
        fused_rtb(**a)
    with pytest.raises(ValueError, match="C=6"):
        fused_conv1d_gn_mish(a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])


def test_kernels_reject_misaligned_inputs(dev):
    a = _args(16, 32, 3, 6, dev, seed=3)
    a["x"] = torch.empty(a["x"].numel() + 1, device=dev)[1:].view(a["x"].shape).copy_(a["x"])
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_rtb(**a)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_conv1d_gn_mish(a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])


def test_denoiser_kernel_path_matches_plain_path(dev):
    m = TemporalUnet1D(24, 8, dim=64).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((96, 24, 8), generator=g, device=dev)
    t = torch.randint(0, 1000, (96,), generator=g, device=dev)
    n = (fused_rtb.launches, fused_conv1d_gn_mish.launches)
    with torch.no_grad():
        got = m(x, t)
        want = m(x, t, use_kernels=False)
    assert (fused_rtb.launches - n[0], fused_conv1d_gn_mish.launches - n[1]) == (16, 1)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert np.isfinite(err) and err < 1e-3


# the 14 distinct (C_in, C_out, T) of the flagship's 16 blocks
FLAGSHIP = SHAPES[:14]
RTB_NAMES = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]


def _grads(fn, a, g):
    ts = {k: v.detach().clone().requires_grad_(True) for k, v in a.items()}
    out = fn(**ts)
    return out, torch.autograd.grad(out, list(ts.values()), g)


@pytest.mark.parametrize("B", [512, 500], ids=["B512", "B500"])
@pytest.mark.parametrize("C,O,T", FLAGSHIP, ids=lambda v: str(v))
def test_fused_rtb_function_gradients_match_plain_autograd(dev, C, O, T, B):
    """Kernel forward + recompute backward against plain autograd; batch 500
    leaves a partial tile of samples in the kernel."""
    a = _args(C, O, B, T, dev, seed=C + 2 * O + T)
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    n = (fused_rtb.launches, FusedRTB.launches, FusedRTB.backwards)
    out, got = _grads(fused_rtb_differentiable, a, g)
    assert "FusedRTB" in out.grad_fn.name()
    want_out, want = _grads(fused_rtb_reference, a, g)
    torch.cuda.synchronize()
    assert (fused_rtb.launches - n[0], FusedRTB.launches - n[1], FusedRTB.backwards - n[2]) == (1, 1, 1)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        torch.testing.assert_close(gt, gw, **TOL, msg=name)


@pytest.mark.parametrize("B", [512, 500], ids=["B512", "B500"])
def test_fused_conv1d_gn_mish_function_gradients_match_plain_autograd(dev, B):
    a = _args(64, 64, B, 24, dev, seed=B)
    a = {k: a[k] for k in ("x", "w1", "b1", "gs1", "gb1")}
    g = torch.randn((B, 24, 64), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    n = (fused_conv1d_gn_mish.launches, FusedConv1dGNMish.backwards)
    head = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_differentiable(x, w1, b1, gs1, gb1)
    plain = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1)
    out, got = _grads(head, a, g)
    want_out, want = _grads(plain, a, g)
    torch.cuda.synchronize()
    assert (fused_conv1d_gn_mish.launches - n[0], FusedConv1dGNMish.backwards - n[1]) == (1, 1)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        torch.testing.assert_close(gt, gw, **TOL, msg=name)


def test_raw_wrappers_refuse_a_gradient_on_cuda(dev):
    a = _args(64, 128, 4, 12, dev, seed=3)
    a["w2"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_rtb_differentiable"):
        fused_rtb(**a)
    x = a["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_conv1d_gn_mish_differentiable"):
        fused_conv1d_gn_mish(x, a["w1"], a["b1"], a["gs1"], a["gb1"])


def test_training_step_goes_through_the_functions(dev):
    """One p_losses gradient of the full-width denoiser: 16 fused-RTB
    launches, all through FusedRTB, and 16 backwards, 1 + 1 for the head, and every parameter's
    gradient within 1e-3 of the plain path's largest entry."""
    m = TemporalUnet1D(24, 8, dim=64).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((96, 24, 8), generator=g, device=dev) * 0.5
    t = torch.randint(0, 1000, (96,), generator=g, device=dev)
    noise = torch.randn((96, 24, 8), generator=g, device=dev)
    cfg, sched = Diffusion1DConfig(rollout_steps=24), make_schedule(1000, device=dev)
    grads = []
    for use_kernels in (True, False):
        n = (fused_rtb.launches, FusedRTB.launches, FusedRTB.backwards,
             fused_conv1d_gn_mish.launches, FusedConv1dGNMish.backwards)
        loss = p_losses(cfg, sched, lambda a, tt: m(a, tt, use_kernels), x, None, t=t, noise=noise)
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
        counts = (fused_rtb.launches - n[0], FusedRTB.launches - n[1], FusedRTB.backwards - n[2],
                  fused_conv1d_gn_mish.launches - n[3], FusedConv1dGNMish.backwards - n[4])
        assert counts == ((16, 16, 16, 1, 1) if use_kernels else (0, 0, 0, 0, 0))
    for (name, _), gk, gp in zip(m.named_parameters(), *grads):
        err = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        assert err <= 1e-3, (name, err)
