"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no GPU is present. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cindm_tpu_torch.models import TemporalUnet1D
from cindm_tpu_torch.ops import (
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_reference,
    fused_rtb,
    fused_rtb_reference,
)

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
    """Two samples: at T=3 and T=6 the tile is shorter than a register pass,
    so the kernel takes its any-length conv path; at T=24 the fixed one."""
    a = _args(C, O, 2, T, dev, seed=C + T)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)


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
