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
    plan = _build.plan_stage(B, T, O if proj else C, O, G)  # proj: a block's second stage, O -> O
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
    assert _build.plan_stage(5376, 3, 1024, 512, 8).n_tile == 128
    assert _build.plan_stage(512, 3, 1024, 512, 8).n_tile == 64  # 32 blocks < 132 SMs
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


# the cuda tests' shapes off the flagship grid, the forward model's
# Conv1dBlocks (batch 32 in training) and the analysis paths' blocks
ODD_SHAPES = [(12, 16, 5), (24, 24, 7), (16, 40, 48)]
FORWARD_MODEL_SHAPES = [(8, 64, 24), (8, 64, 2), (64, 64, 2), (64, 128, 1), (128, 256, 1),
                        (512, 512, 1), (1024, 512, 1), (512, 256, 1), (256, 128, 2),
                        (128, 64, 2), (1024, 512, 3), (64, 64, 24)]
ANALYSIS_RTB_SHAPES = [(4, 64, 24), (8, 64, 70), (64, 64, 70), (64, 128, 35), (512, 512, 35),
                       (1024, 512, 35), (128, 64, 35)]


def _backward_plans():
    for C, O, T in RTB_SHAPES:
        for B in (1, 5, 500, 512, 5376):
            yield C, O, T, B, True
    for B in (1, 5, 500, 512, 5376):
        yield (*HEAD_SHAPE, B, False)
    for C, O, T in ODD_SHAPES:
        yield C, O, T, 37, True
        yield C, O, T, 37, False
    for C, O, T in FORWARD_MODEL_SHAPES:
        for B in (32, 31, 1000):
            yield C, O, T, B, False
    for C, O, T in ANALYSIS_RTB_SHAPES:
        for B in (33, 128):
            yield C, O, T, B, True


@pytest.mark.parametrize("C,O,T,B,rtb", list(_backward_plans()), ids=lambda v: str(v))
def test_plan_backward_is_legal_at_every_shape_of_the_denoiser(C, O, T, B, rtb):
    """Every launch of the backward (gn_mish_bwd, the dgrad of conv2 with the
    first GroupNorm's backward, the dgrad to x, wgrad's split-K) tiles
    whole samples, whole groups where a GroupNorm reduces, covers every row
    tile once, and fits the H100's shared memory; the dgrads split K over
    clusters that run in one wave on 132 SMs; gn_mish_bwd tiles its own
    rows, a warp two (sample, group) pairs."""
    G, og = 8, O // 8
    plan = _build.plan_backward(B, T, C, O, G, proj=C != O, rtb=rtb)
    assert plan.samples == 192 // T and plan.row_tiles == -(-B // plan.samples)
    assert plan.nt_d1 == 64 and 0 < plan.smem_d1 <= _build.SMEM_MAX == 232448
    # gn_mish_bwd: an N tile of whole groups, a line of 32 channels where G
    # allows and a multiple of 8; at most 16 pairs a CTA, two a warp; whole samples
    gpt = plan.nt_gn // og
    assert plan.nt_gn % og == 0 and (plan.nt_gn % 8 == 0 or plan.nt_gn == O)
    assert plan.nt_gn >= min(32, O) and 1 <= gpt <= 16 and plan.gn_samples * gpt <= 16
    assert plan.gn_threads == 32 * -(-plan.gn_samples * gpt // 2)
    assert plan.gn_tiles == -(-B // plan.gn_samples) and plan.grid_gn == (plan.gn_tiles, -(-O // plan.nt_gn))
    planes = 2 if rtb and C != O else 1
    # the staged planes, then the column sums
    assert plan.smem_gn == 4 * (planes * plan.gn_samples * T * _build.gn_stride(plan.nt_gn)
                                + 4 * plan.gn_samples * plan.nt_gn) <= _build.SMEM_MAX
    # fewer samples only where two CTAs would not share an SM or an SM would get none
    if plan.gn_samples < 16 // gpt:
        more = plan.gn_samples + 1
        assert (_build.gn_bwd_smem_bytes(plan.nt_gn, more, T, planes) > _build.SMEM_MAX // 2
                or -(-B // more) * plan.grid_gn[1] < 132)
    # the dgrads: an N tile of 64 channels (dgrad_gn_stage: 128 where 64 holds
    # no whole groups); K split over clusters of 1 to 4 CTAs, each CTA on
    # an SM of its own, all the grid's clusters at once, every rank at least
    # two ring stages (16 input channels a stage at 64, 8 at 128)
    limits = dict(zip((1, 2, 3, 4), (132, 66, 44, 33)))
    assert _build.default_cluster_limits(132) == tuple(limits.values())

    def cluster_ok(cs, tiles, stages):
        if cs != 1:
            assert tiles <= limits[cs] and stages >= 2 * cs
        bigger = [c for c in limits if c > cs and tiles <= limits[c] and stages >= 2 * c]
        assert not bigger  # the largest that fits

    ring = lambda nt: (3 * (12 * 1024 + 2 * 20480) if nt == 64 else 2 * (6 * 1024 + 40960))
    stages_n = lambda nt: 3 if nt == 64 else 2
    assert plan.nt_d1 == 64 and plan.smem_d1 == 1024 + ring(64) + 16 * 3 == 160816
    assert plan.cs_d1 in limits and plan.grid_d1 == (plan.row_tiles * plan.cs_d1, -(-C // 64))
    cluster_ok(plan.cs_d1, plan.row_tiles * -(-C // 64), -(-O // 16))
    if rtb:
        assert plan.nt_d2 in (64, 128) and (O <= plan.nt_d2 or plan.nt_d2 % og == 0)
        assert plan.smem_d2 <= _build.SMEM_MAX
        assert plan.nt_d2 == _build.plan_stage(B, T, O, O, G).n_tile or plan.nt_d2 == 64
        assert plan.nt_d2 == (64 if O <= 64 or 64 % og == 0 else 128)
        nt = plan.nt_d2
        tile = 192 * (nt + 4) * 4
        # the GroupNorm backward's column sums (a rank's samples) over the
        # partial tile once the cluster is done with it
        cols = 12 * -(-plan.samples // plan.cs_d2) * nt
        assert plan.smem_d2 == 1024 + max(ring(nt), tile, cols) + tile + 16 * stages_n(nt)
        assert plan.cs_d2 in limits and plan.grid_d2 == (plan.row_tiles * plan.cs_d2, -(-O // nt))
        cluster_ok(plan.cs_d2, plan.row_tiles * -(-O // nt), -(-O // (16 if nt == 64 else 8)))
    else:
        assert plan.nt_d2 == plan.smem_d2 == plan.cs_d2 == 0
    # wgrad: dw1 (C inputs, 5 taps), dw2 (O, 5), dwres (C, 1), 64 x 64 channel tiles
    # over runs of whole ring stages that cover every row once
    jobs = [(C, 5)] + ([(O, 5)] if rtb else []) + ([(C, 1)] if rtb and C != O else [])
    assert [(ca, taps) for ca, taps, _ in plan.wgrad_jobs] == jobs
    # four stages of 64 activation rows with a halo of 2 either side in two
    # boxes of 128 bytes a row (9 swizzle periods of 1,024 bytes each), and 8
    # k8 steps of the cotangent's big and small planes of 64 channels; 1,024
    # bytes of alignment and 8 barriers
    assert plan.wgrad_smem == 1024 + 4 * (2 * 9 * 1024 + 8 * 2 * 64 * 8 * 4) + 64 <= _build.SMEM_MAX
    stages = -(-B * T // (48 if T == 3 else 64))  # ring stages: whole samples at T = 3
    items = wpart = 0
    for (ca, taps, tiles), n, per in zip(plan.wgrad_jobs, plan.splits, plan.sps):
        assert tiles == -(-ca // 64) * -(-O // 64)
        assert n >= 1 and per >= 1 and (n - 1) * per < stages <= n * per
        assert n == 1 or per >= 4  # a split runs at least four stages
        covered = [0] * stages
        for sp in range(n):
            for st in range(sp * per, min(stages, (sp + 1) * per)):
                covered[st] += 1
        assert covered == [1] * stages
        items += tiles * n
        wpart += n * taps * ca * O * 4 if n > 1 else 0
    assert plan.wgrad_items == items and plan.wpart_bytes == wpart
    assert plan.wgrad_grid == min(items, 132)
    groups = -(-B * T // 48) * 6 if T == 3 else -(-B * T // 8)
    assert plan.wop_bytes == -(-O // 64) * groups * 2 * 512 * 4
    # per gn_mish_bwd row tile 4 kinds of the last GroupNorm's column partials
    # (the head: 3), then per row tile and rank of dgrad_gn_stage's cluster 3
    # of the first's
    assert plan.colpart_bytes == ((4 * plan.gn_tiles + 3 * plan.cs_d2 * plan.row_tiles) if rtb
                                  else 3 * plan.gn_tiles) * O * 4


def test_dgrad_clusters_fill_the_card_at_t3():
    """At batch 512, with the planner's default cluster limits for 132 SMs,
    every T = 3 launch of both dgrads runs at least 96 CTAs (grid x
    cluster), where one CTA a tile ran 32 or 64 (128 for dgrad_x_stage at
    1024 -> 512)."""
    for C, O, T in RTB_SHAPES:
        if T != 3:
            continue
        plan = _build.plan_backward(512, T, C, O, 8, proj=C != O)
        assert plan.grid_d2[0] * plan.grid_d2[1] >= 96, (C, O, plan)
        assert plan.grid_d1[0] * plan.grid_d1[1] >= 96, (C, O, plan)
        assert plan.row_tiles * -(-O // plan.nt_d2) <= 64 and plan.row_tiles * -(-C // 64) <= 128


def test_plan_backward_sizes_the_staged_weights():
    """w2 and w1 flipped and transposed, and wres^T, laid out for the dgrad
    stages' N tiles; without dx only w2 (the head: nothing)."""
    p = _build.plan_backward(512, 3, 1024, 512, 8, proj=True)
    w2 = _build.staged_weight_bytes(p.nt_d2, 512, 512)
    w1 = _build.staged_weight_bytes(p.nt_d1, 512, 1024)
    wr = _build.staged_weight_bytes(p.nt_d1, 512, 1024, K=1)
    assert p.wstage_bytes == w2 + w1 + wr
    assert _build.plan_backward(512, 3, 1024, 512, 8, proj=True, want_dx=False).wstage_bytes == w2
    assert _build.plan_backward(512, 24, 64, 64, 8, proj=False, rtb=False, want_dx=False).wstage_bytes == 0
    # the first block's dx has 8 channels: a 64-wide tile with 8 live columns
    assert _build.plan_backward(512, 24, 8, 64, 8, proj=True).nt_d1 == 64


def test_backward_args_mirror_the_c_structure():
    """BackwardArgs is 36 pointers, 4 sizes and 35 ints (grad_reduce's plan
    last), in that order, as BlockBwdArgs in csrc/block_backward.cu
    declares them."""
    import ctypes
    fields = _build.BackwardArgs._fields_
    assert [t for _, t in fields[:36]] == [ctypes.c_void_p] * 36
    assert [t for _, t in fields[36:40]] == [ctypes.c_longlong] * 4
    assert [n for n, _ in fields[36:40]] == ["wstage_bytes", "wpart_bytes", "colpart_bytes",
                                             "wop_bytes"]
    assert [n for n, _ in fields[-6:]] == ["wg_grid", "splits", "sps", "rd_width", "rd_items", "rd_grid"]
    assert ctypes.sizeof(_build.BackwardArgs) == 36 * 8 + 4 * 8 + 17 * 4 + 6 * 4 + 12 * 4 + 4  # + padding
    src = (_build.CSRC / "block_backward.cu").read_text()
    body = src[src.index("struct BlockBwdArgs {"):src.index("};", src.index("struct BlockBwdArgs {"))]
    import re
    declared = re.findall(r"\b(?:const float|float|uint32_t)\*\s*(\w+);", body)
    assert declared == [n for n, _ in fields[:36]]
    ints = re.findall(r"\bint ([^;]*);", body)
    assert [n.strip().split("[")[0] for line in ints for n in line.split(",")] == [
        n for n, _ in fields[40:]]


def test_carve_gives_aligned_disjoint_views_of_one_allocation():
    """The wrappers' buffers come from one allocation per launch: every view
    starts on a 16-byte boundary (the kernels move 16 bytes a thread) and
    no two overlap."""
    views = _build.carve(torch.device("cpu"), (3, 5), None, (7,), (2, 2, 2), (1,))
    assert views[1] is None
    live = [v for v in views if v is not None]
    assert [tuple(v.shape) for v in live] == [(3, 5), (7,), (2, 2, 2), (1,)]
    base = live[0].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in live)
    assert all(v.data_ptr() % 16 == 0 for v in live) and all(v.is_contiguous() for v in live)
    spans = sorted((v.data_ptr(), v.data_ptr() + 4 * v.numel()) for v in live)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
