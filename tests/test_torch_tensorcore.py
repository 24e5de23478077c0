"""The arithmetic and the tile plan of the port's tensor-core stage kernel
(``cindm_tpu_torch/ops/csrc/conv_gn_mish.cuh``), checked on the CPU.

The kernel splits every fp32 operand a into big = tf32_rna(a) and
small = tf32_rna(a - big) and takes each product as small*big + big*small +
big*big (3xTF32). Here the split is held to its definition, a plain-torch
emulation of the 3xTF32 Conv1d+GN+Mish is held to the port's and the JAX
package's plain versions at fp32's tolerance, and ``_build.plan_stage`` is
held to the rules the kernel's tiling needs at every shape the denoiser
launches."""

import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish_reference as jax_cgm_reference
from cindm_tpu_torch.ops import _build, fused_conv1d_gn_mish_reference
from torch_port_helpers import conv_gn_mish_3xtf32, tf32_rna, tf32_split

TOL = 1e-4  # the kernels' limit against their plain versions, fp32
K = 5
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)


def _f32(bits):
    return np.array(bits, dtype=np.uint32).view(np.float32)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    one = 0x3F800000
    cases = {
        one + 0x0FFF: one,           # below half a tf32 ulp: down
        one + 0x1000: one + 0x2000,  # a tie: away from zero
        one + 0x1001: one + 0x2000,
        one + 0x2000 + 0x1000: one + 0x4000,  # a tie above an odd tf32 value: still away
        0x80000000 | (one + 0x1000): 0x80000000 | (one + 0x2000),  # negative tie: away from zero
        one + 0x7FF000: 0x40000000,  # the carry moves into the exponent: 1.99999 -> 2
        0x00000001: 0x00000000,      # the smallest subnormal rounds to +0
        0x00001000: 0x00002000,      # a subnormal tie rounds away from zero
        0x80001000: 0x80002000,
        0x007FF000: 0x00800000,      # the largest subnormals round up into the normals
        0x7F7FFFFF: 0x7F800000,      # the largest float rounds to inf
        0xFF7FFFFF: 0xFF800000,
        0x7F800000: 0x7F800000,      # +inf and -inf stay
        0xFF800000: 0xFF800000,
        0x00000000: 0x00000000,
        0x80000000: 0x80000000,
    }
    got = _bits(tf32_rna(_f32(list(cases))))
    np.testing.assert_array_equal(got, np.array(list(cases.values()), dtype=np.uint32))
    nan = tf32_rna(_f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF]))
    assert np.isnan(nan).all() and (_bits(nan) == 0x7FFFFFFF).all()


def test_tf32_split_is_exact_where_the_rest_is_representable():
    rng = np.random.default_rng(0)
    a = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * np.float32(10.0) ** rng.integers(-30, 30, 20000),
        _f32(rng.integers(1, 0x00800000, 2000)),  # subnormals
    ]).astype(np.float32)
    big, small = tf32_split(a)
    assert (_bits(big) & 0x1FFF == 0).all() and (_bits(small) & 0x1FFF == 0).all()
    rest = a - big  # exact: big lies within one tf32 ulp of a
    np.testing.assert_array_equal(rest.astype(np.float64), a.astype(np.float64) - big)
    exact = small == rest  # the rest fits in tf32's 11 significant bits
    assert exact.mean() > 0.1
    np.testing.assert_array_equal(big[exact] + small[exact], a[exact])
    # everywhere, big + small keeps about 22 bits: fp32's 24 less two (of a
    # subnormal, whose rest rounds at the same place as its big part, all
    # but the last 12 bits of its 23)
    err = np.abs(a.astype(np.float64) - big - small.astype(np.float64))
    assert (err <= np.abs(a.astype(np.float64)) * 2.0 ** -21 + 2.0 ** -137).all()


@pytest.mark.parametrize("T", [3, 6, 12, 24])
def test_3xtf32_conv_gn_mish_matches_the_plain_versions(T):
    """At narrow widths the emulated kernel arithmetic agrees with the port's
    plain version and the JAX package's reference within TOL, and single-pass
    TF32 would not: the tolerance sees the difference."""
    rng = np.random.default_rng(T)
    C, O, B = 48, 64, 6
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((K, C, O)) / np.sqrt(K * C)).astype(np.float32)
    b, gb = (0.1 * rng.standard_normal((2, O))).astype(np.float32)
    gs = (1 + 0.1 * rng.standard_normal(O)).astype(np.float32)
    got = conv_gn_mish_3xtf32(x, w, b, gs, gb).numpy()
    want = fused_conv1d_gn_mish_reference(*map(torch.from_numpy, (x, w, b, gs, gb))).numpy()
    want_jax = np.asarray(jax_cgm_reference(x, w, b, gs, gb))
    for ref in (want, want_jax):
        err = np.abs(got - ref).max()
        assert err <= TOL and err / np.abs(ref).max() <= TOL, err
    one_pass = conv_gn_mish_3xtf32(x, w, b, gs, gb, passes=1).numpy()
    assert np.abs(one_pass - want).max() > 10 * np.abs(got - want).max()


def _plans():
    for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
        for B in (1, 5, 500, 512, 5376):
            for proj in (False, True):
                yield C, O, T, B, proj


@pytest.mark.parametrize("C,O,T,B,proj", list(_plans()),
                         ids=lambda v: str(v))
def test_plan_stage_is_legal_at_every_shape_of_the_denoiser(C, O, T, B, proj):
    G = 8
    plan = _build.plan_stage(B, T, C, O, G, proj=proj)
    og = O // G
    assert plan.smem_bytes <= _build.SMEM_MAX == 232448
    assert plan.samples == _build.TILE_ROWS // T and plan.samples * T <= 192  # whole samples
    assert O <= plan.n_tile or plan.n_tile % og == 0  # whole groups in every N tile
    assert plan.n_tile in (64, 128)
    rows, cols = plan.grid
    assert (rows - 1) * plan.samples < B <= rows * plan.samples
    assert (cols - 1) * plan.n_tile < O <= cols * plan.n_tile
    # the weight blocks the stage copies in: per N tile and chunk of 8 inputs,
    # K taps x (big, small) x n_tile/8 blocks of core matrices, 256 bytes each
    assert plan.weight_bytes(C) == cols * -(-C // 8) * 2 * K * (plan.n_tile // 8) * 256
    assert plan.weight_bytes(C) % 16 == 0  # one bulk copy per block


def test_plan_stage_prefers_the_wide_tile_and_falls_back_where_the_grid_is_small():
    assert _build.plan_stage(5376, 3, 1024, 512, 8, proj=True).n_tile == 128
    assert _build.plan_stage(512, 3, 1024, 512, 8, proj=True).n_tile == 64  # 32 blocks < 132 SMs
    assert _build.plan_stage(5376, 24, 64, 64, 8).n_tile == 64
    assert _build.plan_stage(5376, 5, 16, 40, 8).n_tile == 64  # one tile holds all 8 groups of 5


@pytest.mark.parametrize("kwargs,match", [
    (dict(B=4, T=24, C=64, O=64, G=8, K=3), "K=5"),
    (dict(B=4, T=193, C=64, O=64, G=8), "T <= 192"),
    (dict(B=4, T=24, C=64, O=1040, G=4), "whole groups"),
])
def test_plan_stage_refuses_what_the_kernel_cannot_tile(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _build.plan_stage(**kwargs)


def test_alignment_rule_of_the_kernels():
    """The stage reads inputs, weights and GroupNorm affines 16 bytes at a
    time, so a CUDA launch needs tensors that start on a 16-byte boundary;
    a view 4 bytes into its storage is refused."""
    base = torch.zeros(65)
    _build.check_aligned("fused_rtb", x=base[:64], wres=None)
    with pytest.raises(ValueError, match="x must start on a 16-byte boundary"):
        _build.check_aligned("fused_rtb", x=base[1:])
