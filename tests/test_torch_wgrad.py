"""The weight gradients of the port's backward kernel (``wgrad`` in
``cindm_tpu_torch/ops/csrc/conv_backward.cuh``), emulated in numpy on the CPU.

The kernel computes dw[k][c][o] = sum_r act[r + k - 2][c] * d[r][o] as a GEMM
with the rows as K: A, the activations, goes to wgmma from registers, each
fragment row shifted by the tap and zero outside its sample, read from a
ring stage that holds 64 rows plus a halo of two either side; B, the
cotangent, comes from shared memory in wgmma's K-major core matrices, split
into tf32 big and small planes as the GroupNorm kernels write it
(``write_wgrad_operand``); products are 3xTF32;
``_build.plan_backward`` splits the rows of a gradient into runs of whole
stages, and the runs' partials are summed in a fixed order. The emulation
below follows those indices (the halo's unloaded rows are NaN, so a mask
that lets one through shows) and is held to ``conv1d_wgrad``'s closed form
and to the JAX package's custom VJP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_rtb import _fused_rtb_cv_bwd
from cindm_tpu_torch.ops import _build, fused_rtb_forward_saving_reference
from cindm_tpu_torch.ops.fused_conv_gn import conv1d_dgrad, conv1d_wgrad, gn_mish_backward_reference
from torch_port_helpers import tf32_rna, tf32_split

K = 5
TOL = 1e-4  # of the closed form's largest entry, as the kernels are held on the card
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
ROWS, HALO, TILE = _build.WG_ROWS, _build.WG_HALO, _build.WG_TILE
# the row of a k8 step at each of wgmma's K positions: t -> 2t, t + 4 -> 2t + 1
ROW_OF_K = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def step_rows(q, T):
    """The rows at K positions 0..7 of the operand layout's group q: 8q +
    ROW_OF_K, or at T = 3, position-major in stages of 48 rows: group g of
    stage st is position g // 2 of samples 8 (g % 2) + ROW_OF_K."""
    if T != 3:
        return 8 * q + ROW_OF_K
    st, g = divmod(q, 6)
    return 48 * st + 3 * (8 * (g % 2) + ROW_OF_K) + g // 2


def n_groups(R, T):
    return -(-R // 48) * 6 if T == 3 else -(-R // 8)


def operand_layout(d, T):
    """d [R, O] as the GroupNorm kernels write it for wgrad: per tile of 64
    channels, group q of 8 K positions and plane (tf32 big, then small) a
    block of 512 words; in a block, n8 block n of 64 words holds the tile's
    channels 8n..8n+7, word w = K position k = (w % 64) // 32 * 4 + w % 4,
    which is row step_rows(q, T)[k], of channel 8n + (w % 32) // 4. Rows and
    channels past d's are zero."""
    R, O = d.shape
    Q, O64 = n_groups(R, T), -(-O // TILE) * TILE
    pad = np.zeros((R + 48, O64), np.float32)
    pad[:R, :O] = d
    rows = np.stack([step_rows(q, T) for q in range(Q)])  # [Q, k]
    out = np.zeros((O64 // TILE, Q, 2, TILE // 8, 2, 8, 4), np.float32)  # [ot, q, p, n8, khalf, n, k4]
    for plane, vals in enumerate(tf32_split(pad)):
        v = vals[rows]  # [Q, k, O64]
        out[:, :, plane] = v.reshape(Q, 2, 4, O64 // TILE, TILE // 8, 8).transpose(3, 0, 4, 1, 5, 2)
    out = out.reshape(-1)
    assert out.size * 4 == _build.wgrad_operand_bytes(R, O, T)
    return out


def read_b(op, R, T, q, plane, o0, n):
    """B [8, n] of k8 step q (K positions, not rows) for channels o0 .. o0 +
    n - 1 (within one tile of 64), read from the operand layout as wgmma's
    descriptor does: K-major core matrices of 8 channels x 4 K positions,
    the K halves 128 bytes apart (LBO), n8 blocks 256 bytes apart (SBO)."""
    base = ((o0 // TILE * n_groups(R, T) + q) * 2 + plane) * 512 + (o0 % TILE) * 8
    k, col = np.arange(8)[:, None], np.arange(n)[None, :]
    return op[base + (col // 8) * 64 + (k // 4) * 32 + (col % 8) * 4 + k % 4]


def wgrad_emulated(act, d, T, taps, splits, sps):
    """The kernel's arithmetic for one weight gradient: act [R, Ca] and d
    [R, O] (rows r = b T + t), ``taps`` 5 (shifts -2..2) or 1 (shift 0),
    the rows cut into ``splits`` runs of ``sps`` stages; returns dw [taps,
    Ca, O] in float32 and the per-split partials. A stage's activation box
    holds its rows and a halo of 2 either side, zeros past the tensor (as
    TMA fills them); a tap is masked where it leaves the row's sample,
    except at T = 3, where a step's rows share one position and the step
    issues only the taps that stay inside."""
    R, Ca = act.shape
    O = d.shape[1]
    op = operand_layout(d, T)
    rows_per_stage = _build.wgrad_stage_rows(T)
    shifts = range(-HALO, HALO + 1) if taps == K else [0]
    parts = np.zeros((splits, taps, Ca, O), np.float32)
    for sp in range(splits):
        r_lo, r_hi = sp * sps * rows_per_stage, min(R, (sp + 1) * sps * rows_per_stage)
        for c0 in range(0, Ca, TILE):
            for o0 in range(0, O, TILE):
                acc = np.zeros((taps, TILE, TILE), np.float32)
                for r0 in range(r_lo, r_hi, rows_per_stage):
                    box = np.zeros((ROWS + 2 * HALO, TILE), np.float32)  # rows r0 - 2 .. r0 + 65
                    lo, hi = max(0, r0 - HALO), min(R, r0 + ROWS + HALO)
                    box[lo - r0 + HALO:hi - r0 + HALO, :min(TILE, Ca - c0)] = act[lo:hi, c0:c0 + TILE]
                    steps = 6 if T == 3 else -(-(min(r_hi, r0 + ROWS) - r0) // 8)
                    for j in range(steps):
                        q = r0 // 48 * 6 + j if T == 3 else (r0 + 8 * j) // 8
                        rows = step_rows(q, T)  # the step's row at each K position
                        bb, bs = (read_b(op, R, T, q, p, o0, TILE) for p in (0, 1))
                        for k, sh in enumerate(shifts):
                            pos = rows % T + sh
                            ok = (rows < R) & (pos >= 0) & (pos < T)
                            if T == 3:
                                if not (0 <= rows[0] % 3 + sh <= 2):
                                    continue  # not issued
                                ok[:] = True  # no mask: rows past R read zeros
                            a = np.where(ok[None, :], box[rows - r0 + sh + HALO].T, 0.0)
                            ab, asm = split_a(np.ascontiguousarray(a, dtype=np.float32))
                            acc[k] += asm @ bb + ab @ bs + ab @ bb  # three wgmma passes
                hc, ho = min(TILE, Ca - c0), min(TILE, O - o0)
                parts[sp, :, c0:c0 + hc, o0:o0 + ho] = acc[:, :hc, :ho]
    out = np.zeros((taps, Ca, O), np.float32)
    for sp in range(splits):  # grad_reduce: the splits in order
        out += parts[sp]
    return out, parts


def split_a(a):
    """wgrad's split of its register operand: big rounded to tf32, small =
    a - big in fp32 (exact), which the tensor cores read truncated to tf32
    (its low 13 bits ignored)."""
    big = tf32_rna(a)
    small = (a - big).astype(np.float32)
    return big, (small.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("T,B,C,O", [(24, 40, 48, 64), (3, 300, 72, 40), (5, 37, 12, 16),
                                     (12, 80, 64, 128), (1, 700, 16, 8)],
                         ids=["T24-split", "T3-split", "T5-ragged", "T12-two-otiles", "T1"])
def test_emulated_wgrad_matches_the_closed_form(T, B, C, O):
    """The emulation, with the plan's splits of B*T rows, agrees with
    conv1d_wgrad within 1e-4 of its largest entry for the five-tap conv
    and the one-tap projection; rows that are not multiples of 8 and
    channels that do not fill a tile included."""
    rng = np.random.default_rng(T * 1000 + B)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    dz = rng.standard_normal((B, T, O)).astype(np.float32)
    plan = _build.plan_backward(B, T, C, O, 8, proj=True, num_sms=132)
    R = B * T
    want = conv1d_wgrad(torch.from_numpy(x), torch.from_numpy(dz), K).numpy()
    got, parts = wgrad_emulated(x.reshape(R, C), dz.reshape(R, O), T, K, plan.splits[0], plan.sps[0])
    assert np.isfinite(got).all() and _rel(got, want) <= TOL
    assert np.array_equal(got, sum(parts[1:], parts[0].copy()))  # fixed order, bit for bit
    want1 = np.einsum("rc,ro->co", x.reshape(R, C), dz.reshape(R, O))[None]
    got1, _ = wgrad_emulated(x.reshape(R, C), dz.reshape(R, O), T, 1, plan.splits[2], plan.sps[2])
    assert _rel(got1, want1) <= TOL


def test_emulated_wgrad_splits_where_the_plan_does():
    """At the first block's shape the plan splits the rows; the emulation
    over its splits agrees with one run over every row within fp32's
    rounding of a different order, and single-pass TF32 would not."""
    rng = np.random.default_rng(0)
    B, T, C, O = 48, 24, 8, 64
    plan = _build.plan_backward(B, T, C, O, 8, proj=True, num_sms=132)
    assert plan.splits[0] > 1
    x = rng.standard_normal((B * T, C)).astype(np.float32)
    dz = rng.standard_normal((B * T, O)).astype(np.float32)
    split, _ = wgrad_emulated(x, dz, T, K, plan.splits[0], plan.sps[0])
    whole, _ = wgrad_emulated(x, dz, T, K, 1, -(-B * T // ROWS))
    want = conv1d_wgrad(torch.from_numpy(x.reshape(B, T, C)), torch.from_numpy(dz.reshape(B, T, O)),
                        K).numpy()
    assert _rel(split, want) <= TOL and _rel(whole, want) <= TOL
    xb, _ = tf32_split(x)
    db, _ = tf32_split(dz)
    one_pass = conv1d_wgrad(torch.from_numpy(xb.reshape(B, T, C)),
                            torch.from_numpy(db.reshape(B, T, O)), K).numpy()
    assert _rel(one_pass, want) > 10 * _rel(split, want)


@pytest.mark.parametrize("C,O,T", [(16, 32, 24), (32, 32, 12), (8, 16, 3)],
                         ids=["proj-T24", "identity-T12", "proj-T3"])
def test_emulated_weight_cotangents_match_jax_custom_vjp(C, O, T):
    """dw1 (x, dz1), dw2 (h, dz2) and dwres (x, g) of the emulation, from
    the closed form's dz1 and dz2, against the JAX package's
    _fused_rtb_cv_bwd on the same numpy inputs, within 1e-4."""
    B = 30
    rng = np.random.default_rng(C + O + T)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(K, O, O, scale=(K * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    proj = C != O
    if proj:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    g = f(B, T, O)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    args = [None if a.get(n) is None else torch.from_numpy(a[n]) for n in names]
    _, h, z1, z2, mean1, rstd1, mean2, rstd2 = fused_rtb_forward_saving_reference(*args)
    gt = torch.from_numpy(g)
    dz2, _, _ = gn_mish_backward_reference(gt, z2, mean2, rstd2, args[8], args[9])
    dz1, _, _ = gn_mish_backward_reference(conv1d_dgrad(dz2, args[6]), z1, mean1, rstd1, args[4],
                                           args[5])
    plan = _build.plan_backward(B, T, C, O, 8, proj=proj, num_sms=132)
    R = B * T
    flat = lambda t: np.ascontiguousarray(t.numpy().reshape(R, -1))
    got = {"w1": wgrad_emulated(flat(args[0]), flat(dz1), T, K, plan.splits[0], plan.sps[0])[0],
           "w2": wgrad_emulated(flat(h), flat(dz2), T, K, plan.splits[1], plan.sps[1])[0]}
    if proj:
        got["wres"] = wgrad_emulated(flat(args[0]), g.reshape(R, O), T, 1, plan.splits[2],
                                     plan.sps[2])[0][0]
    res = tuple(None if a.get(n) is None else jnp.asarray(a[n]) for n in names)
    cot = _fused_rtb_cv_bwd(8, 1e-5, 32, res, jnp.asarray(g))
    for name, val in got.items():
        want = np.asarray(cot[names.index(name)])
        assert val.shape == want.shape, name
        assert _rel(val, want) <= TOL, name


@pytest.mark.parametrize("T", [5, 3])
def test_operand_layout_round_trips_through_the_descriptor_reads(T):
    """Every entry of d, read back through read_b at every k8 step, lands
    where wgmma takes B[k][n] = d[step_rows(q, T)[k]][n], split into the two
    planes, every row once; the padding rows and channels (to the tile's
    64) read zero."""
    rng = np.random.default_rng(3)
    R, O = 105, 12
    d = rng.standard_normal((R, O)).astype(np.float32)
    op = operand_layout(d, T)
    big, small = tf32_split(d)
    seen = []
    for q in range(n_groups(R, T)):
        rows = step_rows(q, T)
        live = rows < R
        seen += list(rows[live])
        for plane, want in ((0, big), (1, small)):
            b = read_b(op, R, T, q, plane, 0, 64)
            assert np.array_equal(b[live, :O], want[rows[live]])
            assert not b[~live].any() and not b[:, O:].any()
    assert sorted(seen) == list(range(R))


def test_wgrad_partials_at_the_training_batch():
    """At batch 512 the 16 blocks' split gradients write at most 150 MB of
    partials, twice the weight gradients' 75.2 MB, and the widest blocks
    are not split at all."""
    total = 0
    for C, O, T in RTB_SHAPES:
        plan = _build.plan_backward(512, T, C, O, 8, proj=C != O)
        total += plan.wpart_bytes
        if T == 3 and min(C, O) == 512:
            assert plan.wpart_bytes == 0 and set(plan.splits) == {1}
    grads = sum(4 * (K * C * O + K * O * O + (C * O if C != O else 0)) for C, O, T in RTB_SHAPES)
    assert round(grads / 1e6, 1) == 75.2
    assert total <= 150e6
    head = _build.plan_backward(512, 24, 64, 64, 8, proj=False, rtb=False)
    assert head.splits[0] > 1 and head.wpart_bytes <= 8e6


@pytest.mark.parametrize("B", [512, 5000, 5376])
def test_wgrad_runs_stay_within_the_row_limit(B):
    """No weight gradient sums more than WG_MAX_RUN_ROWS rows in one run: at
    batch 5,376 the 256 -> 128 (T = 12) block's dwres once ran all 64,512
    rows in one accumulator and ended 4.7e-4 of its largest entry from the
    float64 plain path (on an H100); at 512 only that job splits for it."""
    for C, O, T in RTB_SHAPES:
        plan = _build.plan_backward(B, T, C, O, 8, proj=C != O)
        rows = _build.wgrad_stage_rows(T)
        assert all(sps * rows <= _build.WG_MAX_RUN_ROWS for sps in plan.sps), (C, O, T, plan.sps)
        if B == 512 and (C, O, T) == (256, 128, 12):
            assert plan.splits[2] == 2 and plan.sps[2] * rows == 3072
