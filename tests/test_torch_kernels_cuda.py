"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no GPU is present. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from cindm_tpu_torch.core import make_schedule
from cindm_tpu_torch.models import TemporalUnet1D
from cindm_tpu_torch.ops import (
    FusedConv1dGNMish,
    FusedRTB,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_backward,
    fused_conv1d_gn_mish_backward_reference,
    fused_conv1d_gn_mish_differentiable,
    fused_conv1d_gn_mish_forward_saving_reference,
    fused_conv1d_gn_mish_reference,
    fused_rtb,
    fused_rtb_backward,
    fused_rtb_backward_reference,
    fused_rtb_differentiable,
    fused_rtb_forward_saving_reference,
    fused_rtb_reference,
    grad_reduce,
    grad_reduce_reference,
    prenorm_linear_attention,
    prenorm_linear_attention_differentiable,
    prenorm_linear_attention_reference,
    downsample1d,
    downsample1d_differentiable,
    downsample1d_reference,
    upsample1d,
    upsample1d_differentiable,
    upsample1d_reference,
)
from cindm_tpu_torch.ops import _build
from cindm_tpu_torch.ops.fused_conv_gn import _conv_gn_mish
from cindm_tpu_torch.ops.fused_rtb import _fused_rtb
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


# grids of more tiles than SMs whose last row tile is ragged: each persistent
# CTA walks several tiles, one of them partly empty (a T = 3 block with the
# projection on N tiles of 128, a T = 6 one on 64, the head's shape)
WALK_CASES = [(1024, 512, 3, 64 * 40 + 5), (512, 256, 6, 32 * 70 + 1), (64, 64, 24, 8 * 200 + 3)]


@pytest.mark.parametrize("C,O,T,B", WALK_CASES, ids=lambda v: str(v))
def test_persistent_walk_with_a_ragged_last_tile(dev, C, O, T, B):
    plan = _build.plan_stage(B, T, C, O, 8, num_sms=_build.num_sms(dev))
    assert plan.tiles > plan.ctas and B % plan.samples, plan
    a = _args(C, O, B, T, dev, seed=C + T + B)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    torch.testing.assert_close(fused_conv1d_gn_mish(*args), fused_conv1d_gn_mish_reference(*args),
                               **TOL)


@pytest.mark.parametrize("C,O,T,B", [(16, 32, 24, 11), (32, 32, 3, 70), (64, 128, 3, 6), (24, 64, 12, 17)],
                         ids=lambda v: str(v))
def test_saved_z_follows_the_emulated_ring_order(dev, C, O, T, B):
    """z1 and z2 of the saving instance against the numpy emulation of the
    ring's chunk, tap and pass order (tests/torch_stage_emulation.py) on
    the same inputs, at the plan's N tile: within 1e-5 of z's largest
    entry (the tensor cores sum a k8 step in their own order); h and out
    within the kernels' limit."""
    from torch_stage_emulation import block_emulated

    a = _args(C, O, B, T, dev, seed=3 * C + O + T)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    got = _fused_rtb(*[a.get(n) for n in names], 8, 1e-5, save=True)
    plans = [_build.plan_stage(B, T, c, O, 8, num_sms=_build.num_sms(dev)) for c in (C, O)]
    out, h, z1, z2, _ = block_emulated({k: v.cpu().numpy() for k, v in a.items()}, plans[0].n_tile, plans=plans)
    for name, want, have in (("z1", z1, got[2]), ("z2", z2, got[3])):
        err = float(np.abs(have.cpu().numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
    for want, have in ((h, got[1]), (out, got[0])):  # after GroupNorm: the kernels' own limit
        torch.testing.assert_close(have.cpu(), torch.from_numpy(want), **TOL)



@pytest.mark.parametrize("B", [5376, 5000, 512])
@pytest.mark.parametrize("C,O,T", [(1024, 512, 3), (512, 256, 6), (64, 128, 12), (64, 64, 24)],
                         ids=lambda v: str(v))
def test_split_tail_matches_plain_in_both_instances(dev, C, O, T, B):
    """A launch whose last, partial wave of tiles is split by K chunks over
    every cluster: the plain and the saving instance against their plain
    versions, two runs the same bits, the split tiles' counters back at 0."""
    plans = [_build.plan_stage(B, T, c, O, 8, num_sms=_build.num_sms(dev)) for c in (C, O)]
    assert any(p.max_parts > 1 for p in plans)
    a = _args(C, O, B, T, dev, seed=C + O + T + B)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    args = [a.get(n) for n in names]
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)
    got = _fused_rtb(*args, 8, 1e-5, save=True)
    for have, want in zip(got, fused_rtb_forward_saving_reference(*args)):
        torch.testing.assert_close(have, want, **TOL)
    assert all(torch.equal(x, y) for x, y in zip(got, _fused_rtb(*args, 8, 1e-5, save=True)))
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in _build.stage_work.counters())


def _odd_weights(shapes, dev, seed):
    """Weights of the given shapes with inf, -inf and NaN among their entries."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        w = rng.standard_normal(shape).astype(np.float32)
        w.reshape(-1)[rng.choice(w.size, 3, replace=False)] = [np.inf, -np.inf, np.nan]
        out.append(torch.from_numpy(w).to(dev))
    return out


# a block's weights (w1, w2 and wres: one launch of three jobs) at the plan's
# N tile at 5,376, and odd shapes (C 8, 12, 40 and 520, O 136, K = 1, ragged
# block counts) with inf and NaN at both N tiles
STAGE_CASES = ([((C, O, T), None) for C, O, T in [(1024, 512, 3), (64, 128, 12), (64, 64, 24), (48, 96, 12)]]
               + [(shapes, nt) for nt in (64, 128)
                  for shapes in ([(K, 12, 136), (1, 40, 136), (K, 8, 64)], [(K, 136, 12), (K, 8, 200), (1, 520, 16)])])


@pytest.mark.parametrize("shapes,nt", STAGE_CASES, ids=lambda v: str(v))
def test_stage_weights_kernel_is_its_plain_version(dev, shapes, nt):
    """cindm_stage_weights against stage_weights_reference bit for bit: a
    call's weights in one launch, every layout the plain version's."""
    if nt is None:
        C, O, T = shapes
        a = _args(C, O, 5, T, dev, seed=C + O)
        nt = _build.plan_stage(5376, T, C, O, 8, num_sms=_build.num_sms(dev)).n_tile
        ws = [w for w in (a["w1"], a["w2"], a.get("wres")) if w is not None]
    else:
        ws = _odd_weights(shapes, dev, seed=len(shapes) + nt)
    stage = _build.WeightStage()
    got = stage.many([(w, nt) for w in ws])
    assert stage.launches == 1 and stage.layouts == len(ws)
    for have, w in zip(got, ws):
        assert torch.equal(have.cpu(), _build.stage_weights_reference(w.cpu(), nt))


@pytest.mark.parametrize("nt", [64, 128])
@pytest.mark.parametrize("C,O", [(1024, 512), (64, 64), (12, 136), (520, 16)], ids=lambda v: str(v))
def test_stage_weights_t_is_the_flipped_plain_version(dev, C, O, nt):
    """The backward's layout (cindm_stage_weights_t, the kernel the backward
    launches first) bit for bit: a block's w2 [K, O, O], w1 [K, C, O] and
    wres [C, O] as the dgrads read them, staged[k][c][o] = w[K - 1 - k][o][c],
    i.e. stage_weights_reference of w flipped in time and transposed."""
    w1, w2, wres = _odd_weights([(K, C, O), (K, O, O), (1, C, O)], dev, seed=C + O + nt)
    ws = [w2, w1, wres]
    outs = [torch.empty(_build.staged_weight_bytes(nt, w.shape[2], w.shape[1], w.shape[0]) // 4,
                        dtype=torch.int32, device=dev) for w in ws]
    n = len(ws)
    args = ((ctypes.c_void_p * n)(*(w.data_ptr() for w in ws)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * (4 * n))(*(d for w in ws for d in (w.shape[0], w.shape[2], w.shape[1], nt))), n)
    _build.raise_on_error("stage_weights_t", _build.call_on(dev, _build.load().cindm_stage_weights_t, *args))
    for have, w in zip(outs, ws):
        want = _build.stage_weights_reference(w.cpu().flip(0).transpose(1, 2).contiguous(), nt)
        assert torch.equal(have.cpu(), want)


@pytest.mark.parametrize("C,O,T", [(1024, 512, 3), (128, 256, 6), (64, 64, 24)], ids=lambda v: str(v))
def test_forward_kernels_stage_each_weight_once_per_version(dev, C, O, T):
    """A block's weights are laid out on their first call, all in one launch,
    and kept: a second call stages nothing; an in-place update (an optimizer
    step) restages only what changed, again in one launch, and the kernel
    then equals the plain version on the new weights (a stale layout would
    not)."""
    a = _args(C, O, 37, T, dev, seed=C + 2 * O + T)
    n, m = _build.staged.launches, _build.staged.layouts
    fused_rtb(**a)
    assert (_build.staged.launches, _build.staged.layouts) == (n + 1, m + (3 if C != O else 2))
    first = fused_rtb(**a)
    assert (_build.staged.launches, _build.staged.layouts) == (n + 1, m + (3 if C != O else 2))
    with torch.no_grad():
        torch._foreach_add_([a["w1"]], [0.01 * torch.ones_like(a["w1"])])
    got = fused_rtb(**a)
    torch.cuda.synchronize()
    assert (_build.staged.launches, _build.staged.layouts) == (n + 2, m + (4 if C != O else 3))
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, fused_rtb_reference(**a), **TOL)


@pytest.mark.parametrize("C,O,T,B", [(1024, 512, 3, 5376), (512, 256, 6, 2241), (64, 64, 24, 5000)],
                         ids=lambda v: str(v))
def test_forward_kernels_repeat_bit_for_bit(dev, C, O, T, B):
    """The epilogue's sums go in fixed orders (no atomics): the same inputs
    give the same bits, out, h, z, mean and rstd alike."""
    a = _args(C, O, B, T, dev, seed=C + O + B)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    first = _fused_rtb(*[a.get(k) for k in names], 8, 1e-5, save=True)
    again = _fused_rtb(*[a.get(k) for k in names], 8, 1e-5, save=True)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert torch.equal(fused_rtb(**a), fused_rtb(**a))
    head = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    assert torch.equal(fused_conv1d_gn_mish(*head), fused_conv1d_gn_mish(*head))

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
    n = (fused_rtb.launches, fused_conv1d_gn_mish.launches, prenorm_linear_attention.launches,
         upsample1d.launches, downsample1d.launches)
    with torch.no_grad():
        got = m(x, t)
        want = m(x, t, use_kernels=False)
    assert (fused_rtb.launches - n[0], fused_conv1d_gn_mish.launches - n[1],
            prenorm_linear_attention.launches - n[2], upsample1d.launches - n[3],
            downsample1d.launches - n[4]) == (16, 1, 8, 3, 3)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert np.isfinite(err) and err < 1e-3


# The backward kernels' cotangents against a plain version: max |kernel -
# plain| <= GRAD_TOL * max |plain| (PERF.md's limit).
GRAD_TOL = 1e-4
# The Function's cotangents that fail TOL entry by entry against plain
# autograd at batch 512 and 500, by name. Each sums over all B*T rows, and
# the backward reads what the 3xTF32 forward saved, so its rounding differs
# from cuDNN's fp32 by about 1e-5 of the largest entry (which reaches
# several hundred); that is more than TOL's atol where an entry lies near
# zero. These are held to GRAD_TOL of the largest entry; every other
# cotangent (x, temb, bres; the head's x, b1, gs1, gb1) and the output
# keep TOL entry by entry.
RTB_SUMMED = {"w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres"}
HEAD_SUMMED = {"w1"}


def _assert_close_or_scaled(got, want, name, summed):
    if name in summed:
        _assert_scaled(got, want, name)
    else:
        torch.testing.assert_close(got, want, **TOL, msg=name)


def _assert_scaled(got, want, name):
    assert got is not None and bool(torch.isfinite(got).all()), name
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * max(float(want.abs().max()), 1e-30), (name, err)


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
    """Kernel forward (saving instance) + backward kernel against plain
    autograd; batch 500 leaves a partial tile of samples in the kernels."""
    a = _args(C, O, B, T, dev, seed=C + 2 * O + T)
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    n = (fused_rtb.launches, FusedRTB.launches, FusedRTB.backwards, fused_rtb_backward.launches)
    out, got = _grads(fused_rtb_differentiable, a, g)
    assert "FusedRTB" in out.grad_fn.name()
    want_out, want = _grads(fused_rtb_reference, a, g)
    torch.cuda.synchronize()
    assert (fused_rtb.launches - n[0], FusedRTB.launches - n[1], FusedRTB.backwards - n[2],
            fused_rtb_backward.launches - n[3]) == (1, 1, 1, 1)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        _assert_close_or_scaled(gt, gw, name, RTB_SUMMED)


@pytest.mark.parametrize("B", [512, 500], ids=["B512", "B500"])
def test_fused_conv1d_gn_mish_function_gradients_match_plain_autograd(dev, B):
    a = _args(64, 64, B, 24, dev, seed=B)
    a = {k: a[k] for k in ("x", "w1", "b1", "gs1", "gb1")}
    g = torch.randn((B, 24, 64), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    n = (fused_conv1d_gn_mish.launches, FusedConv1dGNMish.backwards,
         fused_conv1d_gn_mish_backward.launches)
    head = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_differentiable(x, w1, b1, gs1, gb1)
    plain = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1)
    out, got = _grads(head, a, g)
    want_out, want = _grads(plain, a, g)
    torch.cuda.synchronize()
    assert (fused_conv1d_gn_mish.launches - n[0], FusedConv1dGNMish.backwards - n[1],
            fused_conv1d_gn_mish_backward.launches - n[2]) == (1, 1, 1)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        _assert_close_or_scaled(gt, gw, name, HEAD_SUMMED)


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
    launches, all through FusedRTB, 16 backwards, each one call of the
    backward kernel, 1 + 1 + 1 for the head, the 8 attentions and the 3 + 3
    resampling convs on their plain path under autograd (no launch of
    theirs), and every parameter's gradient within 1e-3 of the plain path's
    largest entry."""
    m = TemporalUnet1D(24, 8, dim=64).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((96, 24, 8), generator=g, device=dev) * 0.5
    t = torch.randint(0, 1000, (96,), generator=g, device=dev)
    noise = torch.randn((96, 24, 8), generator=g, device=dev)
    cfg, sched = Diffusion1DConfig(rollout_steps=24), make_schedule(1000, device=dev)
    grads = []
    for use_kernels in (True, False):
        n = (fused_rtb.launches, FusedRTB.launches, FusedRTB.backwards,
             fused_conv1d_gn_mish.launches, FusedConv1dGNMish.backwards,
             fused_rtb_backward.launches, fused_conv1d_gn_mish_backward.launches,
             prenorm_linear_attention.launches, prenorm_linear_attention_differentiable.autograd_calls,
             upsample1d.launches + downsample1d.launches,
             upsample1d_differentiable.autograd_calls + downsample1d_differentiable.autograd_calls)
        loss = p_losses(cfg, sched, lambda a, tt: m(a, tt, use_kernels), x, None, t=t, noise=noise)
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
        counts = (fused_rtb.launches - n[0], FusedRTB.launches - n[1], FusedRTB.backwards - n[2],
                  fused_conv1d_gn_mish.launches - n[3], FusedConv1dGNMish.backwards - n[4],
                  fused_rtb_backward.launches - n[5], fused_conv1d_gn_mish_backward.launches - n[6],
                  prenorm_linear_attention.launches - n[7],
                  prenorm_linear_attention_differentiable.autograd_calls - n[8],
                  upsample1d.launches + downsample1d.launches - n[9],
                  upsample1d_differentiable.autograd_calls + downsample1d_differentiable.autograd_calls - n[10])
        assert counts == ((16, 16, 16, 1, 1, 16, 1, 0, 8, 0, 6) if use_kernels else (0,) * 11)
    for (name, _), gk, gp in zip(m.named_parameters(), *grads):
        err = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        assert err <= 1e-3, (name, err)


# -- the backward kernels against their plain closed forms, on the same saved tensors


def _rtb_saved(C, O, B, T, dev, seed):
    a = _args(C, O, B, T, dev, seed)
    args = [a.get(n) for n in RTB_NAMES]
    out, *saved = _fused_rtb(*args, 8, 1e-5, save=True)
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return args, out, saved, g


@pytest.mark.parametrize("B", [512, 2, 500], ids=["B512", "B2", "B500"])
@pytest.mark.parametrize("C,O,T", FLAGSHIP, ids=lambda v: str(v))
def test_fused_rtb_backward_kernel_matches_closed_form(dev, C, O, T, B):
    """The saving forward's tensors against its plain version, then the
    backward kernel against the closed form on the same saved tensors; two
    samples leave a tile mostly empty, 500 a partial last tile."""
    args, out, saved, g = _rtb_saved(C, O, B, T, dev, seed=C + O + T + B)
    want_fwd = fused_rtb_forward_saving_reference(*args, 8, 1e-5)
    for name, got, want in zip(["out", "h", "z1", "z2", "mean1", "rstd1", "mean2", "rstd2"],
                               [out, *saved], want_fwd):
        torch.testing.assert_close(got, want, **TOL, msg=name)
    full = args + saved
    needs = [True] * 10 + [C != O] * 2
    n = fused_rtb_backward.launches
    got = fused_rtb_backward(full, g, needs)
    torch.cuda.synchronize()
    assert fused_rtb_backward.launches == n + 1
    want = fused_rtb_backward_reference(full, g, needs)
    for name, gt, gw in zip(RTB_NAMES, got, want):
        if gw is None:
            assert gt is None, name
        else:
            _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("C,O,T", SHAPES[14:], ids=lambda v: str(v))
def test_backward_kernels_at_odd_shapes(dev, C, O, T):
    """Shapes off the flagship's grid: 12 input channels, groups of 2 and 5
    channels, T = 5, 7 and 48 (tiles of 38, 27 and 4 samples, row counts
    that are not multiples of 8), batch 37; the block's and the head's
    backward against their closed forms."""
    args, _, saved, g = _rtb_saved(C, O, 37, T, dev, seed=C * T)
    needs = [True] * 10 + [C != O] * 2
    got = fused_rtb_backward(args + saved, g, needs)
    for name, gt, gw in zip(RTB_NAMES, got, fused_rtb_backward_reference(args + saved, g, needs)):
        if gw is not None:
            _assert_scaled(gt, gw, name)
    head = [args[0], args[2], args[3], args[4], args[5]]
    _, *hsaved = _conv_gn_mish(*head, 8, 1e-5, save=True)
    got = fused_conv1d_gn_mish_backward([*head, *hsaved], g, [True] * 5)
    want = fused_conv1d_gn_mish_backward_reference([*head, *hsaved], g, [True] * 5)
    for name, gt, gw in zip(["x", "w", "b", "gn_scale", "gn_bias"], got, want):
        _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("C,O,T,B", [(48, 96, 12, 37), (512, 1024, 3, 64)], ids=lambda v: str(v))
def test_backward_kernels_with_groups_no_64_channel_tile_holds(dev, C, O, T, B):
    """GroupNorm groups of 12 and 128 channels, which no N tile of 64 holds
    whole: dgrad_gn_stage runs its N tile of 128 (a ring of 8 channels a
    stage); the block's backward against its closed form."""
    args, _, saved, g = _rtb_saved(C, O, B, T, dev, seed=C + O)
    needs = [True] * 12
    got = fused_rtb_backward(args + saved, g, needs)
    for name, gt, gw in zip(RTB_NAMES, got, fused_rtb_backward_reference(args + saved, g, needs)):
        if gw is not None:
            _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("C,O,T", [(8, 64, 24), (1024, 512, 3), (256, 256, 6)], ids=lambda v: str(v))
def test_fused_rtb_backward_without_dx(dev, C, O, T):
    """x needs no gradient (the first block in training): no dx, and the
    dgrad to x is not launched; every other cotangent as with it."""
    args, _, saved, g = _rtb_saved(C, O, 64, T, dev, seed=C + T)
    needs = [False] + [True] * 9 + [C != O] * 2
    got = fused_rtb_backward(args + saved, g, needs)
    want = fused_rtb_backward_reference(args + saved, g, needs)
    assert got[0] is None and want[0] is None
    for name, gt, gw in zip(RTB_NAMES[1:], got[1:], want[1:]):
        if gw is not None:
            _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("C,O,T", [(512, 512, 3), (64, 128, 12)], ids=lambda v: str(v))
def test_fused_rtb_backward_repeats_bit_for_bit(dev, C, O, T):
    """No atomics: two runs on the same inputs give equal gradients."""
    args, _, saved, g = _rtb_saved(C, O, 512, T, dev, seed=5)
    needs = [True] * 12
    first = fused_rtb_backward(args + saved, g, needs)
    second = fused_rtb_backward(args + saved, g, needs)
    for name, a, b in zip(RTB_NAMES, first, second):
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("B", [512, 2, 500], ids=["B512", "B2", "B500"])
def test_fused_conv1d_gn_mish_backward_kernel_matches_closed_form(dev, B):
    a = _args(64, 64, B, 24, dev, seed=B + 1)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    out, *saved = _conv_gn_mish(*args, 8, 1e-5, save=True)
    for name, got, want in zip(["out", "z", "mean", "rstd"], [out, *saved],
                               fused_conv1d_gn_mish_forward_saving_reference(*args)):
        torch.testing.assert_close(got, want, **TOL, msg=name)
    g = torch.randn((B, 24, 64), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    n = fused_conv1d_gn_mish_backward.launches
    for needs in ([True] * 5, [False] + [True] * 4):
        got = fused_conv1d_gn_mish_backward([*args, *saved], g, needs)
        want = fused_conv1d_gn_mish_backward_reference([*args, *saved], g, needs)
        assert (got[0] is None) == (not needs[0])
        for name, gt, gw in zip(["x", "w", "b", "gn_scale", "gn_bias"], got, want):
            if gw is not None:
                _assert_scaled(gt, gw, name)
    again = fused_conv1d_gn_mish_backward([*args, *saved], g, [True] * 5)
    assert all(torch.equal(x, y) for x, y in zip(again, fused_conv1d_gn_mish_backward(
        [*args, *saved], g, [True] * 5)))
    torch.cuda.synchronize()
    assert fused_conv1d_gn_mish_backward.launches == n + 4


def test_backward_kernels_refuse_cpu_tensors(dev):
    a = {k: v.cpu() for k, v in _args(16, 32, 2, 6, dev, seed=9).items()}
    args = [a.get(n) for n in RTB_NAMES]
    out, *saved = fused_rtb_forward_saving_reference(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fused_rtb_backward(args + list(saved), torch.ones_like(out), [True] * 12)


# The later paths' shapes: the forward model's Conv1dBlocks at horizon 24
# and 2 (T down to 1, C up to 1,024, the 8-channel stem), the 1-body prior's
# 4-channel stem, the horizon-70 direct model's T=70 and T=35 blocks.
FORWARD_MODEL_SHAPES = [(8, 64, 24), (8, 64, 2), (64, 64, 2), (64, 128, 1), (128, 256, 1),
                        (512, 512, 1), (1024, 512, 1), (512, 256, 1), (256, 128, 2),
                        (128, 64, 2), (1024, 512, 3), (64, 64, 24)]
ANALYSIS_RTB_SHAPES = [(4, 64, 24), (8, 64, 70), (64, 64, 70), (64, 128, 35), (512, 512, 35),
                       (1024, 512, 35), (128, 64, 35)]


@pytest.mark.parametrize("B", [1000, 4, 999, 3], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,O,T", FORWARD_MODEL_SHAPES, ids=lambda v: str(v))
def test_fused_conv1d_gn_mish_at_forward_model_shapes(dev, C, O, T, B):
    a = _args(C, O, B, T, dev, seed=C + O + T + B)
    args = (a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"])
    torch.testing.assert_close(fused_conv1d_gn_mish(*args), fused_conv1d_gn_mish_reference(*args),
                               **TOL)


@pytest.mark.parametrize("B", [32, 4, 31], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,O,T", FORWARD_MODEL_SHAPES, ids=lambda v: str(v))
def test_fused_conv1d_gn_mish_function_x_only_gradient(dev, C, O, T, B):
    """Design by backprop: the parameters need no gradient, so the backward
    kernel runs without wgrad and returns dx alone."""
    a = _args(C, O, B, T, dev, seed=C * 3 + O + T + B)
    w = (a["w1"], a["b1"], a["gs1"], a["gb1"])
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    outs = []
    for fn in (fused_conv1d_gn_mish_differentiable, fused_conv1d_gn_mish_reference):
        x = a["x"].clone().requires_grad_(True)
        out = fn(x, *w)
        outs.append((out.detach(), *torch.autograd.grad(out, [x], g)))
    n = fused_conv1d_gn_mish_backward.launches
    x = a["x"].clone().requires_grad_(True)
    fused_conv1d_gn_mish_differentiable(x, *w).backward(g)
    torch.cuda.synchronize()
    assert fused_conv1d_gn_mish_backward.launches == n + 1
    (out_k, dx_k), (out_p, dx_p) = outs
    torch.testing.assert_close(out_k, out_p, **TOL)
    torch.testing.assert_close(dx_k, dx_p, **TOL)


@pytest.mark.parametrize("C,O,T", FORWARD_MODEL_SHAPES, ids=lambda v: str(v))
def test_fused_conv1d_gn_mish_function_gradients_at_forward_model_shapes(dev, C, O, T):
    B = 32
    a = _args(C, O, B, T, dev, seed=C + O * 5 + T)
    a = {k: a[k] for k in ("x", "w1", "b1", "gs1", "gb1")}
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    head = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_differentiable(x, w1, b1, gs1, gb1)
    plain = lambda x, w1, b1, gs1, gb1: fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1)
    out, got = _grads(head, a, g)
    want_out, want = _grads(plain, a, g)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("B", [128, 16, 127, 15], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,O,T", ANALYSIS_RTB_SHAPES, ids=lambda v: str(v))
def test_fused_rtb_at_analysis_shapes(dev, C, O, T, B):
    a = _args(C, O, B, T, dev, seed=C + O + T + B)
    torch.testing.assert_close(fused_rtb(**a), fused_rtb_reference(**a), **TOL)


@pytest.mark.parametrize("C,O,T", [(4, 64, 24), (8, 64, 70), (64, 128, 35)], ids=lambda v: str(v))
def test_fused_rtb_function_gradients_at_analysis_shapes(dev, C, O, T):
    B = 33
    a = _args(C, O, B, T, dev, seed=C + 2 * O + T)
    g = torch.randn((B, T, O), generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    out, got = _grads(fused_rtb_differentiable, a, g)
    want_out, want = _grads(fused_rtb_reference, a, g)
    torch.testing.assert_close(out, want_out, **TOL)
    for name, gt, gw in zip(a, got, want):
        _assert_scaled(gt, gw, name)


@pytest.mark.parametrize("C,O,T", [(1024, 512, 1), (8, 64, 2), (512, 512, 35)], ids=lambda v: str(v))
def test_backward_kernels_without_weight_gradients(dev, C, O, T):
    """needs asks for dx (and dtemb) only: wgrad and the reduction do not
    run, and dx equals the closed form's."""
    args, _, saved, g = _rtb_saved(C, O, 40, T, dev, seed=C + T)
    got = fused_rtb_backward(args + saved, g, [True, True] + [False] * 10)
    want = fused_rtb_backward_reference(args + saved, g, [True, True] + [False] * 10)
    assert all(x is None for x in got[2:])
    for name, gt, gw in zip(RTB_NAMES[:2], got[:2], want[:2]):
        _assert_scaled(gt, gw, name)
    head = [args[0], args[2], args[3], args[4], args[5]]
    _, *hsaved = _conv_gn_mish(*head, 8, 1e-5, save=True)
    hg = torch.randn((40, T, O), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    got = fused_conv1d_gn_mish_backward([*head, *hsaved], hg, [True] + [False] * 4)
    want = fused_conv1d_gn_mish_backward_reference([*head, *hsaved], hg, [True] + [False] * 4)
    assert all(x is None for x in got[1:])
    _assert_scaled(got[0], want[0], "x")


# grad_reduce alone: the backward pass's 17 job lists at 512 (the 16 blocks
# and the head, planned with the card's cluster limits) and odd job lists
REDUCE_SHAPES = [(8, 64, 24, True), (64, 64, 24, True), (64, 128, 12, True), (128, 128, 12, True),
                 (128, 256, 6, True), (256, 256, 6, True), (256, 512, 3, True), (512, 512, 3, True),
                 (1024, 512, 3, True), (512, 256, 3, True), (512, 256, 6, True), (256, 128, 6, True),
                 (256, 128, 12, True), (128, 64, 12, True), (64, 64, 24, False)]


def _reduce_jobs(jobs, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((S * n,), generator=g, device=dev), S) for n, S in jobs]


def _assert_in_order(jobs):
    got = grad_reduce(jobs)
    want = [grad_reduce_reference(src, S) for src, S in jobs]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, grad_reduce(jobs)))


@pytest.mark.parametrize("C,O,T,rtb", REDUCE_SHAPES, ids=lambda v: str(v))
def test_grad_reduce_kernel_is_the_in_order_sum(dev, C, O, T, rtb):
    """Each sum bit-identical to grad_reduce_reference, twice, on the
    backward's own job list; every launch at least min(items, 132) CTAs."""
    plan = _build.plan_backward(512, T, C, O, 8, proj=rtb and C != O, rtb=rtb,
                                num_sms=_build.num_sms(dev), clusters=_build.cluster_limits(dev)).reduce
    assert plan.grid >= min(plan.items, 132)
    n = grad_reduce.launches
    _assert_in_order(_reduce_jobs(plan.jobs, dev, seed=C + O + T))
    assert grad_reduce.launches == n + 2


@pytest.mark.parametrize("jobs", [
    [(4, 1)], [(12, 5000)], [(2052, 3), (8, 7), (4100, 1)], [(16384, 2)] * 10,
    [(65536, 40), (64, 3000)],
], ids=["one-column", "runs-of-slices", "ragged", "ten-jobs", "wide-and-deep"])
def test_grad_reduce_kernel_at_odd_job_lists(dev, jobs):
    """A single column group, slices beyond a ring stage (the slab in runs
    of slices), ragged last items, ten jobs at once, and a launch whose
    items outnumber the grid."""
    _assert_in_order(_reduce_jobs(jobs, dev, seed=len(jobs)))


def test_grad_reduce_refuses_what_the_kernel_cannot_take(dev):
    with pytest.raises(ValueError, match="multiple of 4"):
        grad_reduce([(torch.ones(2 * 6, device=dev), 2)])
    with pytest.raises(ValueError, match="16-byte"):
        grad_reduce([(torch.ones(2 * 8 + 1, device=dev)[1:], 2)])
    with pytest.raises(ValueError, match="1 to 10 jobs"):
        grad_reduce([(torch.ones(8, device=dev), 2)] * 11)


# -- the linear attention kernel (PreNormResidual(LinearAttentionTemporal))

# (C, T) of the flagship's 8 attention blocks, and the horizon-70 direct model's
ATTN_SHAPES = [(64, 24), (128, 12), (256, 6), (512, 3), (512, 3), (256, 3), (128, 6), (64, 12)]
ATTN_LONG = [(64, 70), (128, 35), (512, 35)]


def _attn_args(C, T, B, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s, fan: (torch.rand(s, generator=g, device=dev) * 2 - 1) * fan ** -0.5
    return (torch.randn((B, T, C), generator=g, device=dev), 1 + 0.1 * torch.randn(C, generator=g, device=dev),
            u(C, 384, fan=C), u(128, C, fan=128), 0.1 * torch.randn(C, generator=g, device=dev))


def _attn_close(got, want):
    """The kernels' limit: max abs error and max error / max |plain| within 1e-4."""
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-4 and err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("B", [5376, 5000, 1], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("C,T", ATTN_SHAPES + ATTN_LONG,
                         ids=[f"blk{i}-C{c}-T{t}" for i, (c, t) in enumerate(ATTN_SHAPES + ATTN_LONG)])
def test_linear_attention_kernel_matches_plain(dev, C, T, B):
    a = _attn_args(C, T, B, dev, seed=C + T + B)
    n = prenorm_linear_attention.launches
    got = prenorm_linear_attention(*a)
    torch.cuda.synchronize()
    assert prenorm_linear_attention.launches == n + 1
    _attn_close(got, prenorm_linear_attention_reference(*a))


@pytest.mark.parametrize("C,T,B", [(64, 24, 5376), (512, 3, 5000), (64, 70, 33)], ids=lambda v: str(v))
def test_linear_attention_repeats_bit_for_bit(dev, C, T, B):
    a = _attn_args(C, T, B, dev, seed=7)
    assert torch.equal(prenorm_linear_attention(*a), prenorm_linear_attention(*a))


def test_linear_attention_refuses_what_it_does_not_take(dev):
    x, g, wqkv, wout, bout = _attn_args(64, 24, 4, dev, seed=1)
    with pytest.raises(TypeError, match="float32"):
        prenorm_linear_attention(x.double(), g, wqkv, wout, bout)
    with pytest.raises(ValueError, match="contiguous"):
        prenorm_linear_attention(x.transpose(0, 1).contiguous().transpose(0, 1), g, wqkv, wout, bout)
    for C, T, why in ((40, 24, "multiple of 16"), (64, 97, "T=97"), (1024, 0, "T=0")):
        with pytest.raises(ValueError, match=why):
            prenorm_linear_attention(*_attn_args(C, T, 2, dev, seed=2))
    with pytest.raises(ValueError, match="16-byte boundary"):
        xs = torch.empty(4 * 24 * 64 + 1, device=dev)[1:].view(4, 24, 64)
        prenorm_linear_attention(xs.copy_(x), g, wqkv, wout, bout)
    with pytest.raises(RuntimeError, match="prenorm_linear_attention_differentiable"):
        prenorm_linear_attention(x.requires_grad_(True), g, wqkv, wout, bout)


@pytest.mark.parametrize("C,T,B", [(1024, 3, 512), (800, 48, 64), (208, 96, 40)], ids=lambda v: str(v))
def test_linear_attention_takes_the_widest_tiles(dev, C, T, B):
    """Shared memory does not depend on C: the 48- and 96-row tiles' widest
    C (800 at T <= 48, 208 above) and C = 1024, which they refused."""
    a = _attn_args(C, T, B, dev, seed=11)
    _attn_close(prenorm_linear_attention(*a), prenorm_linear_attention_reference(*a))


def test_linear_attention_route_under_autograd_is_plain(dev):
    """With a gradient wanted the block takes its plain version (no launch,
    one autograd call), and its input gradient is plain autograd's."""
    x, *w = _attn_args(64, 24, 8, dev, seed=3)
    x.requires_grad_(True)
    n = (prenorm_linear_attention.launches, prenorm_linear_attention_differentiable.autograd_calls)
    out = prenorm_linear_attention_differentiable(x, *w)
    assert (prenorm_linear_attention.launches - n[0],
            prenorm_linear_attention_differentiable.autograd_calls - n[1]) == (0, 1)
    (gx,) = torch.autograd.grad(out.square().sum(), x)
    (want,) = torch.autograd.grad(prenorm_linear_attention_reference(x, *w).square().sum(), x)
    assert torch.equal(gx, want)


# -- the resampling kernel (Upsample1d, Downsample1d) against its plain version

# (kind, C, T in) of the flagship's 3 Downsample1d and 3 Upsample1d, and the later paths' odd ones
RESAMPLE_SHAPES = [("down", 64, 24), ("down", 128, 12), ("down", 256, 6), ("up", 256, 3), ("up", 128, 6),
                   ("up", 64, 12)]
RESAMPLE_ODD = [("down", 64, 70), ("up", 64, 35), ("down", 64, 2), ("up", 64, 1), ("down", 40, 14),
                ("up", 12, 5), ("down", 1024, 6), ("up", 1024, 3)]
# two shapes for each instance resample<N tile, up>, at a batch whose last partial wave is split
RESAMPLE_INSTANCES = {(64, "up", 24): ("up", 320, 24), (128, "up", 8): ("up", 256, 8),
                      (64, "down", 16): ("down", 320, 16), (128, "down", 48): ("down", 256, 48),
                      (64, "up", 35): ("up", 320, 35), (128, "up", 35): ("up", 256, 35),
                      (64, "down", 14): ("down", 192, 14), (128, "down", 70): ("down", 256, 70)}


def _resample_args(kind, C, T, B, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    fan = (4 if kind == "up" else 3) * C
    u = lambda *s: (torch.rand(s, generator=g, device=dev) * 2 - 1) * fan ** -0.5
    return (torch.randn((B, T, C), generator=g, device=dev), u(C, C, 4) if kind == "up" else u(3, C, C), u(C))


def _resample_fns(kind):
    return (upsample1d, upsample1d_reference) if kind == "up" else (downsample1d, downsample1d_reference)


@pytest.mark.parametrize("B", [5376, 5000, 1], ids=lambda b: f"B{b}")
@pytest.mark.parametrize("kind,C,T", RESAMPLE_SHAPES + RESAMPLE_ODD, ids=lambda v: str(v))
def test_resample_kernel_matches_plain(dev, kind, C, T, B):
    a = _resample_args(kind, C, T, B, dev, seed=C + T + B)
    kern, plain = _resample_fns(kind)
    n = kern.launches
    got = kern(*a)
    torch.cuda.synchronize()
    assert kern.launches == n + 1 and got.shape == plain(*a).shape
    _attn_close(got, plain(*a))


@pytest.mark.parametrize("key", list(RESAMPLE_INSTANCES), ids=str)
def test_resample_instance_matches_plain(dev, key):
    """Each instance of the kernel against the plain version, on a plan with
    a split tail, twice (the same bits)."""
    kind, C, T = RESAMPLE_INSTANCES[key]
    B = 1111
    plan = _build.plan_resample(B, T, C, kind == "up", _build.num_sms(dev))
    assert (plan.n_tile, kind, T) == key and plan.tail > 0
    a = _resample_args(kind, C, T, B, dev, seed=C + T)
    kern, plain = _resample_fns(kind)
    got = kern(*a)
    _attn_close(got, plain(*a))
    assert torch.equal(got, kern(*a))


@pytest.mark.parametrize("kind,C,T,B", [("up", 256, 3, 5376), ("down", 64, 24, 5000), ("up", 40, 7, 33)],
                         ids=lambda v: str(v))
def test_resample_repeats_bit_for_bit(dev, kind, C, T, B):
    a = _resample_args(kind, C, T, B, dev, seed=5)
    kern, _ = _resample_fns(kind)
    assert torch.equal(kern(*a), kern(*a))


def test_resample_refuses_what_it_does_not_take(dev):
    x, w, b = _resample_args("down", 64, 24, 4, dev, seed=1)
    with pytest.raises(TypeError, match="float32"):
        downsample1d(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        downsample1d(x.transpose(0, 1).contiguous().transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="even T"):
        downsample1d(*_resample_args("down", 64, 7, 2, dev, seed=2))
    with pytest.raises(ValueError, match="multiple of 4"):
        upsample1d(*_resample_args("up", 30, 6, 2, dev, seed=2))
    with pytest.raises(ValueError, match="rows a sample"):
        upsample1d(*_resample_args("up", 8, 193, 2, dev, seed=2))
    with pytest.raises(ValueError, match="16-byte boundary"):
        xs = torch.empty(4 * 24 * 64 + 1, device=dev)[1:].view(4, 24, 64)
        downsample1d(xs.copy_(x), w, b)
    with pytest.raises(RuntimeError, match="downsample1d_differentiable"):
        downsample1d(x.requires_grad_(True), w, b)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_resample_route_under_autograd_is_plain(dev, kind):
    """With a gradient wanted the conv takes its plain version (no launch, one
    autograd call), and its input gradient is plain autograd's."""
    x, w, b = _resample_args(kind, 64, 12, 8, dev, seed=3)
    kern, plain = _resample_fns(kind)
    route = upsample1d_differentiable if kind == "up" else downsample1d_differentiable
    x.requires_grad_(True)
    n = (kern.launches, route.autograd_calls)
    out = route(x, w, b)
    assert (kern.launches - n[0], route.autograd_calls - n[1]) == (0, 1)
    (gx,) = torch.autograd.grad(out.square().sum(), x)
    (want,) = torch.autograd.grad(plain(x, w, b).square().sum(), x)
    assert torch.equal(gx, want)


def test_resample_layouts_once_per_weight_version(dev):
    """The phase weights' layouts: one stage_weights launch for a weight's
    two, none on the next call, one again after an in-place update."""
    x, w, b = _resample_args("up", 128, 6, 64, dev, seed=4)
    n = _build.staged.launches
    upsample1d(x, w, b)
    upsample1d(x, w, b)
    assert _build.staged.launches == n + 1
    with torch.no_grad():
        w.mul_(0.5)
    _attn_close(upsample1d(x, w, b), upsample1d_reference(x, w, b))
    assert _build.staged.launches == n + 2


def test_fused_rtb_reads_a_row_strided_temb(dev):
    """The time projection of every block in one product: each block's temb a
    column view of it, the kernel's result the same bits as a copy's."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, T, C, O = 512, 12, 64, 128
    f = lambda *s, sc=1.0: sc * torch.randn(s, generator=g, device=dev)
    wide = f(B, 3 * O)
    temb = wide[:, O:2 * O]
    ps = [f(5, C, O, sc=0.05), f(O), 1 + f(O, sc=0.1), f(O, sc=0.1), f(5, O, O, sc=0.05), f(O),
          1 + f(O, sc=0.1), f(O, sc=0.1), f(C, O, sc=0.1), f(O)]
    x = f(B, T, C)
    assert torch.equal(fused_rtb(x, temb, *ps), fused_rtb(x, temb.contiguous(), *ps))
    xr = x.clone().requires_grad_(True)
    assert torch.equal(fused_rtb_differentiable(xr, temb, *ps), fused_rtb_differentiable(xr, temb.contiguous(), *ps))
    with pytest.raises(ValueError, match="multiple of 4 floats"):
        fused_rtb(x, f(B, O + 2)[:, :O], *ps)
