"""The GroupNorm + Mish backward of the port's backward kernel
(``gn_bwd_tile`` in ``cindm_tpu_torch/ops/csrc/conv_backward.cuh``: the
kernel ``gn_mish_bwd`` and ``dgrad_gn_stage``'s epilogue), emulated in numpy
on the CPU.

``gn_mish_bwd`` tiles its own rows (``_build.plan_backward``: ``gn_samples``
whole samples x ``nt_gn`` channels of whole groups a CTA); a warp takes
(sample, group) pairs, two at a time in ``gn_mish_bwd`` and one in the
epilogue, with every load issued first. A lane takes V channels of a pair (1
in groups of up to 32 channels, 2 up to 64, 4 up to 128) at position cu of
the L lanes of a row (the group's og / V load units rounded up to a power of
2) and the rows slot, slot + 32 / L, ..; it holds 8 floats of d and of z at
a time, and a pair beyond that goes in chunks. The pair's two means are
xor-butterfly sums over the warp; the lane's sums per channel over its rows
are summed over the lanes of the channel by halving exchanges, a butterfly's
sums in a fixed order; the CTA sums the pairs' column sums over its samples
in order into one partial row, and ``grad_reduce`` sums the rows in order.
The emulation below follows that partition in float32 and is held to the
closed form (``gn_mish_backward_reference``) and to the JAX package's custom
VJP; the plan and the operand writes of the new row tiles are checked beside
it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_rtb import _fused_rtb_cv_bwd
from cindm_tpu_torch.ops import _build, fused_rtb_forward_saving_reference
from cindm_tpu_torch.ops.fused_conv_gn import conv1d_dgrad, gn_mish_backward_reference
from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, RTB_SHAPES
from test_torch_dgrad import ROW_OF_K, operand_writes

TOL = 1e-4  # of the closed form's largest entry, as the kernels are held on the card
LANE_FLOATS = 8  # of d (and of z) a lane holds at once: kGnLaneFloats
F32 = np.float32


def lanes(og, T):
    """The warp's partition of a (sample, group) pair of T x og elements:
    (V, U, L, RP, steps, chunks)."""
    V = _build.gn_lane_floats(og)
    U = og // V
    L = 1 << (U - 1).bit_length()
    RP = 32 // L
    steps = -(-T // RP)
    return V, U, L, RP, steps, -(-steps // (LANE_FLOATS // V))


def to_lanes(x, og, T):
    """x [n, T, og] -> [n, 32 lanes, steps, V]: lane slot * L + cu holds rows
    slot + RP k, channels cu V .. cu V + V - 1 (zero where there is none)."""
    V, _, L, RP, steps, _ = lanes(og, T)
    out = np.zeros((x.shape[0], steps * RP, L * V), F32)
    out[:, :T, :og] = x
    return out.reshape(-1, steps, RP, L, V).transpose(0, 2, 3, 1, 4).reshape(-1, 32, steps, V)


def from_lanes(y, og, T):
    """The inverse of ``to_lanes``: [n, 32, steps, V] -> [n, T, og]."""
    V, _, L, RP, steps, _ = lanes(og, T)
    x = y.reshape(-1, RP, L, steps, V).transpose(0, 3, 1, 2, 4).reshape(-1, steps * RP, L * V)
    return x[:, :T, :og]


def xor_sum(v, offs):
    """Butterfly sums over the last axis (32 lanes), in the kernel's order."""
    lane = np.arange(32)
    for off in offs:
        v = (v + v[..., lane ^ off]).astype(F32)
    return v


def mish_grad32(y):
    """mish_grad of conv_backward.cuh in float32 (its two reciprocals)."""
    e = np.exp(np.minimum(y, F32(20))).astype(F32)
    n = e * (e + F32(2))
    r = F32(1) / (n + F32(2))
    return (n * r + y * (e / (F32(1) + e)) * (F32(4) * (n + F32(1))) * (r * r)).astype(F32)


def pairs_emulated(d, z, mean, rstd, gs, gb):
    """Every (sample, group) pair as its warp computes it: dz [B, T, O] and
    the pair's column sums [B, O] of dy yh (dgs), dy (dgb), dz (db) and d
    (dbres, dtemb)."""
    B, T, O = d.shape
    G = mean.shape[1]
    og = O // G
    V, U, L, RP, steps, _ = lanes(og, T)
    pair = lambda a: a.reshape(B, T, G, og).transpose(0, 2, 1, 3).reshape(B * G, T, og)
    dl, zl = to_lanes(pair(d), og, T), to_lanes(pair(z), og, T)
    live = to_lanes(np.ones((B * G, T, og), F32), og, T) > 0
    cu = np.arange(32) % L
    ch = np.where(cu[:, None] < U, cu[:, None] * V + np.arange(V), 0)  # [32, V] channel in the group
    gidx = np.arange(B * G) % G
    gsl = np.where(live[:, :, :1], gs.reshape(G, og)[gidx][:, ch][:, :, None], 0).astype(F32)
    gbl = np.where(live[:, :, :1], gb.reshape(G, og)[gidx][:, ch][:, :, None], 0).astype(F32)
    mu = mean.reshape(-1)[:, None, None, None].astype(F32)
    rs = rstd.reshape(-1)[:, None, None, None].astype(F32)
    yh = ((zl - mu) * rs).astype(F32)
    dy = np.where(live, dl * mish_grad32((yh * gsl + gbl).astype(F32)), 0).astype(F32)
    # the lane's sums over its rows, step by step (chunks in order); s1, s2 over (step, channel)
    sums = [np.zeros((B * G, 32, V), F32) for _ in range(3)]
    s1, s2 = np.zeros((B * G, 32), F32), np.zeros((B * G, 32), F32)
    for k in range(steps):
        sums[0] = (sums[0] + dy[:, :, k] * yh[:, :, k]).astype(F32)
        sums[1] = (sums[1] + dy[:, :, k]).astype(F32)
        sums[2] = (sums[2] + dl[:, :, k]).astype(F32)
        for j in range(V):
            s1 = (s1 + dy[:, :, k, j] * gsl[:, :, 0, j]).astype(F32)
            s2 = (s2 + dy[:, :, k, j] * gsl[:, :, 0, j] * yh[:, :, k, j]).astype(F32)
    n = F32(1.0 / (T * og))
    m1 = (xor_sum(s1, (16, 8, 4, 2, 1)) * n)[:, :, None, None]
    m2 = (xor_sum(s2, (16, 8, 4, 2, 1)) * n)[:, :, None, None]
    dz = np.where(live, rs * (dy * gsl - m1 - yh * m2), 0).astype(F32)
    db = np.zeros((B * G, 32, V), F32)
    for k in range(steps):
        db = (db + dz[:, :, k]).astype(F32)
    # each channel's lane sums over its RP lanes: the kernel's halving
    # exchanges add the same partial sums as a butterfly over lane bits L, ..
    col_offs = [1 << b for b in range(L.bit_length() - 1, 5)]
    cols = []
    for s in (sums[0], sums[1], db, sums[2]):
        s = xor_sum(s.transpose(0, 2, 1), col_offs)[:, :, :L]  # slot 0: lanes 0 .. L - 1
        cols.append(s.transpose(0, 2, 1).reshape(B * G, L * V)[:, :og].reshape(B, O))
    dz_rows = from_lanes(dz, og, T).reshape(B, G, T, og).transpose(0, 2, 1, 3).reshape(B, T, O)
    return dz_rows, cols


def tile_partials(cols, tiles):
    """Each tile's partial row (its samples' pair sums in order), then
    grad_reduce's sum of the rows in order. ``tiles``: the samples of each
    partial row, in row order."""
    total = np.zeros(cols.shape[1], F32)
    for samples in tiles:
        row = np.zeros(cols.shape[1], F32)
        for b in samples:
            row = (row + cols[b]).astype(F32)
        total = (total + row).astype(F32)
    return total


def gn_tiles(plan, B):
    return [range(rt * plan.gn_samples, min(B, (rt + 1) * plan.gn_samples)) for rt in range(plan.gn_tiles)]


def epilogue_tiles(plan, B):
    """dgrad_gn_stage's partial rows: per row tile of 192 // T samples and
    cluster rank, the rank's share of the tile's samples."""
    S, cs = plan.samples, plan.cs_d2
    out = []
    for rt in range(plan.row_tiles):
        ns = min(S, B - rt * S)
        out += [range(rt * S + ns * q // cs, rt * S + ns * (q + 1) // cs) for q in range(cs)]
    return out


def gn_inputs(O, T, B, seed):
    """Seeded d, z and the statistics of z (as the forward saves them), gs, gb."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((B, T, O)) * 1.5 + 0.3).astype(F32)
    d = rng.standard_normal((B, T, O)).astype(F32)
    G = 8
    zg = z.reshape(B, T, G, O // G).astype(np.float64)
    mean = zg.mean((1, 3)).astype(F32)
    rstd = (1 / np.sqrt(zg.var((1, 3)) + 1e-5)).astype(F32)
    gs = (1 + 0.1 * rng.standard_normal(O)).astype(F32)
    gb = (0.1 * rng.standard_normal(O)).astype(F32)
    return d, z, mean, rstd, gs, gb


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("O,T,B", [
    (64, 24, 9), (128, 12, 13), (256, 6, 7), (512, 3, 37), (256, 3, 35), (32, 3, 21), (40, 5, 11),
    (16, 2, 20), (24, 7, 6), (96, 12, 5), (256, 24, 3),
], ids=["og8-T24", "og16-T12", "og32-T6", "og64-T3", "og32-T3-half", "og4-T3", "og5-T5",
        "og2-T2", "og3-T7", "og12-T12", "og32-T24-chunks"])
def test_emulated_gn_mish_bwd_matches_the_closed_form(O, T, B):
    """dz, dgs, dgb, db and dbres of the emulated partition (the plan's row
    tiles, the warps' pairs, the fixed-order sums) agree with the closed
    form within 1e-4 of its largest entry: the training shapes' groups (8 to
    64 channels), groups that are not a multiple of 4 channels (one channel
    a lane), ragged last tiles, and a pair beyond a warp's registers."""
    d, z, mean, rstd, gs, gb = gn_inputs(O, T, B, seed=O + T + B)
    plan = _build.plan_backward(B, T, O, O, 8, proj=False)
    dz, cols = pairs_emulated(d, z, mean, rstd, gs, gb)
    t = torch.from_numpy
    want_dz, want_dgs, want_dgb = gn_mish_backward_reference(t(d), t(z), t(mean), t(rstd), t(gs), t(gb))
    want = dict(dz=want_dz.numpy(), dgs=want_dgs.numpy(), dgb=want_dgb.numpy(),
                db=want_dz.numpy().sum((0, 1)), dbres=d.sum((0, 1)))
    tiles = gn_tiles(plan, B)
    got = dict(dz=dz, **{k: tile_partials(c, tiles) for k, c in zip(("dgs", "dgb", "db", "dbres"), cols)})
    for name, w in want.items():
        assert _rel(got[name], w) <= TOL, name


def test_pairs_beyond_a_warp_go_in_chunks():
    """At the training shapes a pair (192 elements, 96 on the half-width
    blocks) fits one chunk of 8 floats a lane, and a pair of 192 fills every
    lane (two channels a lane, 3 rows); T = 24 with 32 channels a group (768
    elements) takes three chunks, and T = 192 with 64 a group 48."""
    for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
        V, U, L, RP, steps, chunks = lanes(O // 8, T)
        assert V == 2 and chunks == 1 and U == L and steps * RP >= T, (C, O, T)
        assert (32 * steps * V == T * O // 8) == (T * O // 8 == 192), (C, O, T)
    assert lanes(32, 24) == (2, 16, 16, 2, 12, 3)
    assert lanes(64, 192) == (2, 32, 32, 1, 192, 48)
    assert lanes(128, 3)[0] == 4 and lanes(62, 12)[0] == 2 and lanes(15, 3)[0] == 1
    assert lanes(5, 5) == (1, 5, 8, 4, 2, 1) and lanes(3, 7) == (1, 3, 4, 8, 1, 1)


@pytest.mark.parametrize("O,T,B,cs", [(64, 24, 17, 4), (128, 12, 40, 4), (512, 3, 70, 2), (96, 12, 9, 1)],
                         ids=["T24-cs4", "T12-cs4", "T3-cs2", "T12-og12"])
def test_emulated_epilogue_matches_the_closed_form(O, T, B, cs):
    """dgrad_gn_stage's epilogue (the same tile code on each rank's share of
    a tile's samples, d in shared memory): dz1, dtemb, and dgs1, dgb1, db1
    summed over (row tile, rank) rows in order, within 1e-4 of the closed
    forms, ranks with no samples included."""
    d, z, mean, rstd, gs, gb = gn_inputs(O, T, B, seed=3 * O + T)
    plan = dataclasses.replace(_build.plan_backward(B, T, O, O, 8, proj=False), cs_d2=cs)
    dz, cols = pairs_emulated(d, z, mean, rstd, gs, gb)
    t = torch.from_numpy
    want_dz, want_dgs, want_dgb = gn_mish_backward_reference(t(d), t(z), t(mean), t(rstd), t(gs), t(gb))
    tiles = epilogue_tiles(plan, B)
    assert sorted(b for s in tiles for b in s) == list(range(B))
    got = [dz, cols[3]] + [tile_partials(c, tiles) for c in cols[:3]]
    want = [want_dz.numpy(), d.sum(1), want_dgs.numpy(), want_dgb.numpy(), want_dz.numpy().sum((0, 1))]
    for name, g, w in zip(("dz1", "dtemb", "dgs1", "dgb1", "db1"), got, want):
        assert _rel(g, w) <= TOL, name


@pytest.mark.parametrize("C,O,T,B", [(16, 32, 24, 11), (64, 64, 3, 40)], ids=["proj-T24", "identity-T3"])
def test_emulated_cotangents_match_jax_custom_vjp(C, O, T, B):
    """The block's GroupNorm cotangents through the emulated partition: gs2,
    gb2, b2 (and bres) from gn_mish_bwd's row tiles, temb, gs1, gb1 and b1
    from dgrad_gn_stage's epilogue on dh = conv_T(dz2, w2), against the JAX
    package's _fused_rtb_cv_bwd on the same numpy inputs, within 1e-4."""
    rng = np.random.default_rng(C + O + T)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(F32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(5, C, O, scale=(5 * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(5, O, O, scale=(5 * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    if C != O:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    g = f(B, T, O)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    args = [None if a.get(n) is None else torch.from_numpy(a[n]) for n in names]
    _, _, z1, z2, mean1, rstd1, mean2, rstd2 = [v.numpy() for v in fused_rtb_forward_saving_reference(*args)]
    plan = _build.plan_backward(B, T, C, O, 8, proj=C != O)
    dz2, cols2 = pairs_emulated(g, z2, mean2, rstd2, a["gs2"], a["gb2"])
    dgs2, dgb2, db2, dbres = (tile_partials(c, gn_tiles(plan, B)) for c in cols2)
    dh = conv1d_dgrad(torch.from_numpy(dz2), args[6]).numpy()
    _, cols1 = pairs_emulated(dh, z1, mean1, rstd1, a["gs1"], a["gb1"])
    dgs1, dgb1, db1 = (tile_partials(c, epilogue_tiles(plan, B)) for c in cols1[:3])
    res = tuple(None if a.get(n) is None else jnp.asarray(a[n]) for n in names)
    cot = _fused_rtb_cv_bwd(8, 1e-5, 32, res, jnp.asarray(g))
    got = {1: cols1[3], 3: db1, 4: dgs1, 5: dgb1, 7: db2, 8: dgs2, 9: dgb2}
    if C != O:
        got[11] = dbres
    for i, v in got.items():
        want = np.asarray(cot[i])
        assert v.shape == want.shape, names[i]
        assert _rel(v, want) <= TOL, names[i]


def colpart_bytes_of_the_launch(plan, B, O, rtb):
    """block_backward.cu's count of the column partials: 4 kinds (3 for the
    head) x gn_tiles x O, then 3 x row tiles x cs_d2 x O."""
    pk = plan.gn_tiles * O
    pk1 = plan.row_tiles * O * (plan.cs_d2 if rtb else 0)
    return ((4 if rtb else 3) * pk + 3 * pk1) * 4


@pytest.mark.parametrize("C,O,T,rtb", [(*s, True) for s in RTB_SHAPES] + [(*HEAD_SHAPE, False)],
                         ids=lambda v: str(v))
def test_gn_plan_fills_the_card_at_the_training_batch(C, O, T, rtb):
    """At batch 512 every gn_mish_bwd launch of the 16 blocks and the head
    runs at least 132 CTAs of at most 8 warps (two pairs each), two CTAs' shared
    memory fit one SM, the tile is at least a 128-byte line of whole groups,
    its rows hold whole 8-row groups of wgrad's operand (whole 48-row stages
    at T = 3), the last GroupNorm's partial rows are no more than
    dgrad_gn_stage's at T = 24 (128), and colpart_bytes is what the launch
    counts."""
    B, og = 512, O // 8
    plan = _build.plan_backward(B, T, C, O, 8, proj=C != O and rtb, rtb=rtb)
    assert plan.grid_gn == (plan.gn_tiles, -(-O // plan.nt_gn))
    assert plan.grid_gn[0] * plan.grid_gn[1] >= 132
    assert plan.gn_threads == 32 * -(-plan.gn_samples * (plan.nt_gn // og) // 2) <= 256
    assert plan.nt_gn % og == 0 and plan.nt_gn >= 32 and plan.nt_gn % 8 == 0
    assert 2 * plan.smem_gn <= _build.SMEM_MAX
    planes = 2 if rtb and C != O else 1
    assert plan.smem_gn == 4 * (planes * plan.gn_samples * T * _build.gn_stride(plan.nt_gn)
                                + 4 * plan.gn_samples * plan.nt_gn)
    rows = plan.gn_samples * T
    assert rows % (48 if T == 3 else 8) == 0
    assert plan.gn_tiles == -(-B // plan.gn_samples) <= 128
    assert plan.colpart_bytes == colpart_bytes_of_the_launch(plan, B, O, rtb)


@pytest.mark.parametrize("T", [1, 2, 5, 7, 48, 96, 192])
def test_any_t_up_to_192_plans_down_to_one_sample(T):
    """Every T <= 192 plans at the widest groups (64 channels at O = 512,
    two staged planes): at T = 192 one sample a CTA, within the shared
    memory of a block; the stride of a staged row is 16 modulo 32."""
    for B in (1, 3, 512):
        plan = _build.plan_backward(B, T, 1024, 512, 8, proj=True)
        assert plan.gn_samples >= 1 and plan.smem_gn <= _build.SMEM_MAX
        assert plan.gn_tiles == -(-B // plan.gn_samples)
    assert _build.plan_backward(4, 192, 1024, 512, 8, proj=True).gn_samples == 1
    assert all(_build.gn_stride(nt) % 32 == 16 and _build.gn_stride(nt) >= nt for nt in range(1, 200))
    with pytest.raises(ValueError, match="groups of at most 32 channels"):
        _build.plan_backward(8, 12, 132, 132, 2, proj=False)


@pytest.mark.parametrize("T,B,O", [(3, 70, 96), (3, 37, 512), (5, 41, 40), (24, 19, 96), (24, 9, 64),
                                   (12, 13, 200)],
                         ids=["T3-og12", "T3-og64", "T5-og5", "T24-og12", "T24-og8", "T12-og25"])
def test_operand_writes_of_the_gn_tiles_cover_the_layout_once(T, B, O):
    """gn_mish_bwd's row tiles (gn_samples samples) and N tiles (nt_gn
    channels) write dz (and g) in wgrad's operand layout: together every
    word once, each the row the layout puts at its K position, zero past
    the rows and channels; at T = 3 and 5 tiles may end inside a stage of 48
    rows or a group of 8."""
    plan = _build.plan_backward(B, T, O, O, 8, proj=False, rtb=False, num_sms=132)
    R = B * T
    seen = {}
    for rt in range(plan.gn_tiles):
        ns = min(plan.gn_samples, B - rt * plan.gn_samples)
        for n0 in range(0, O, plan.nt_gn):
            ncols = min(plan.nt_gn, O - n0)
            for key, row in operand_writes(rt * plan.gn_samples * T, ns * T, R, T, n0, ncols, O):
                assert key not in seen, key
                seen[key] = row
    groups = -(-R // 48) * 6 if T == 3 else -(-R // 8)
    assert len(seen) == groups * -(-O // 64) * 64 * 8
    for (q, o, kpos), row in seen.items():
        want = 48 * (q // 6) + 3 * (8 * (q % 6 % 2) + ROW_OF_K[kpos]) + q % 6 // 2 if T == 3 \
            else 8 * q + ROW_OF_K[kpos]
        assert row == (want if want < R and o < O else -1), (q, o, kpos)
