"""The dgrads of the port's backward kernel (``dgrad_gn_stage`` and
``dgrad_x_stage`` in ``cindm_tpu_torch/ops/csrc/conv_backward.cuh``),
emulated in numpy on the CPU.

A CTA tiles 192 rows of whole samples x an N tile of 64 output channels (128
where 64 holds no whole GroupNorm groups); its three warpgroups hold 64 tile
rows each (row-major, or position-major at T <= 3, where a warpgroup issues
only a window of 3 of the 5 taps). K, the cotangent's channels x taps, is
split over a cluster of cs CTAs: rank q takes the q-th run of whole ring
stages (16 input channels a stage at 64), each stage staged as the tile's
192 rows by TMA. Per chunk of 8 channels and tap, A (the thread's fragment
rows, shifted by the tap and zero outside their sample) comes from registers,
split for 3xTF32 as wgrad splits it, and B (the flipped, transposed weights,
tf32 big and small planes) from shared memory. After a cluster barrier rank q
sums its share of the tile's rows over the ranks' partials in the order 0, 1,
..: dgrad_x_stage writes dx (plus the identity residual), dgrad_gn_stage's
share is whole samples, on which it runs the first GroupNorm's backward and
writes its column partials per (row tile, rank), which grad_reduce sums in
that order. The emulation below follows those indices (rows and channels of
a staged box that the kernel never loads are NaN, so a mask that lets one
through shows) and is held to the closed forms and to the JAX package's
custom VJP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_rtb import _fused_rtb_cv_bwd
from cindm_tpu_torch.ops import _build, fused_rtb_forward_saving_reference
from cindm_tpu_torch.ops.fused_conv_gn import conv1d_dgrad, gn_mish_backward_reference
from torch_port_helpers import tf32_rna, tf32_split
from torch_stage_emulation import tile_rows

K = 5
TOL = 1e-4  # of the closed form's largest entry, as the kernels are held on the card
ROWS = _build.TILE_ROWS


def split_a(a):
    """The dgrads' split of their register operand (wgrad's): big rounded to
    tf32, small = a - big in fp32 (exact), which the tensor cores read
    truncated to tf32."""
    big = tf32_rna(a)
    small = (a - big).astype(np.float32)
    return big, (small.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def rank_chunks(cin, q, cs, ch):
    """ring_part: rank q's chunks [c0, c1) of 8 channels, whole ring stages of ch chunks."""
    nch = -(-cin // 8)
    nst = -(-nch // ch)
    return min(nch, nst * q // cs * ch), min(nch, nst * (q + 1) // cs * ch)


def staged_box(d, row0, nrows, c0, c1):
    """A rank's view of its channels [8 c0, 8 c1) of the tile's 192 rows from
    row0 as its TMA boxes hold them: rows past the tensor and channels past
    it zero; rows past the tile's live rows and channels of other ranks
    (which the kernel never loads) NaN."""
    R, C = d.shape
    box = np.full((ROWS, 8 * c1), np.nan, np.float32)
    box[:nrows, 8 * c0:] = 0.0
    box[:nrows, 8 * c0:min(C, 8 * c1)] = d[row0:row0 + nrows, 8 * c0:8 * c1]
    return box


def gemm_part(acc, box, ws, c0, c1, rows, passes, one_tap=False):
    """One rank's share of K into acc [192, NT] (tile rows): per chunk and
    tap of each warpgroup's window, A [64, 8] from the box (shifted, masked)
    and B [8, NT] from ws [taps, Cin, NT] (tf32 big, small), 3xTF32."""
    r, live, ok, klo, KW = rows
    wb, wsm = tf32_split(ws)
    for c in range(c0, c1):
        for wg in range(3):
            j = slice(64 * wg, 64 * wg + 64)
            for k in ([0] if one_tap else range(klo[wg], klo[wg] + KW)):
                m = live[j] if one_tap else ok[j, k]
                src = np.where(m, r[j] + (0 if one_tap else k - 2), 0)
                a = np.where(m[:, None], box[src, 8 * c:8 * c + 8], 0.0).astype(np.float32)
                ab, asm = split_a(a)
                bb, bs = wb[k, 8 * c:8 * c + 8], wsm[k, 8 * c:8 * c + 8]
                if passes == 1:
                    acc[j] += ab @ bb
                else:
                    acc[j] += asm @ bb + ab @ bs + ab @ bb


def cluster_sum(d, ws, T, cs, nt, res=None, passes=3):
    """conv_T(d) [R, Cout] (+ the 1x1 product of ``res`` = (g, wres^T [1,
    Cres, Cout]) in the same accumulators) as the dgrads compute it: per
    row tile and N tile, each rank's partial over its stages, summed over
    the ranks in order. Returns the [R, Cout] sum."""
    R, cin = d.shape
    cout = ws.shape[2]
    S = ROWS // T
    B = R // T
    ch = _build.stage_ring(nt)[0]
    out = np.zeros((R, cout), np.float32)
    for rt in range(-(-B // S)):
        ns = min(S, B - rt * S)
        row0, nrows = rt * S * T, ns * T
        rows = tile_rows(S, ns, T)
        for n0 in range(0, cout, nt):
            wt = np.zeros((ws.shape[0], ws.shape[1], nt), np.float32)
            wt[:, :, :min(nt, cout - n0)] = ws[:, :, n0:n0 + nt]
            total = None
            for q in range(cs):  # the ranks in order
                acc = np.zeros((ROWS, nt), np.float32)
                c0, c1 = rank_chunks(cin, q, cs, ch)
                gemm_part(acc, staged_box(d, row0, nrows, c0, c1), wt, c0, c1, rows, passes)
                if res is not None:
                    g, wr = res
                    rt_ = np.zeros((1, wr.shape[1], nt), np.float32)
                    rt_[:, :, :min(nt, cout - n0)] = wr[:, :, n0:n0 + nt]
                    c0, c1 = rank_chunks(g.shape[1], q, cs, ch)
                    gemm_part(acc, staged_box(g, row0, nrows, c0, c1), rt_, c0, c1, rows, passes,
                              one_tap=True)
                part = np.zeros((nrows, nt), np.float32)  # the rank's partial tile, natural rows
                part[rows[0][rows[1]]] = acc[rows[1]]
                total = part if total is None else total + part
            out[row0:row0 + nrows, n0:n0 + nt] = total[:, :min(nt, cout - n0)]
    assert np.isfinite(out).all()  # no NaN of an unloaded row or channel got through
    return out


def flipped(w):
    """stage_weights_t's order: ws[k][o][c] = w[K - 1 - k][c][o]."""
    return np.ascontiguousarray(np.flip(w, 0).transpose(0, 2, 1))


def dgrad_gn_emulated(dz2, w2, z1, mean1, rstd1, gs1, gb1, T, cs, nt=64, passes=3):
    """dgrad_gn_stage: dh, then per rank's share of each tile's samples the
    first GroupNorm's backward; the column partials per (row tile, rank)
    summed in that order. Returns dh, dz1, dtemb, dgs1, dgb1, db1."""
    B, _, O = dz2.shape
    dh = cluster_sum(dz2.reshape(B * T, O), flipped(w2), T, cs, nt, passes=passes).reshape(B, T, O)
    S = ROWS // T
    dz1 = np.zeros_like(dh)
    cols = np.zeros((3, O), np.float32)
    t = torch.from_numpy
    for rt in range(-(-B // S)):
        ns = min(S, B - rt * S)
        for q in range(cs):
            s0, s1 = rt * S + ns * q // cs, rt * S + ns * (q + 1) // cs
            dz, dgs, dgb = gn_mish_backward_reference(
                t(dh[s0:s1]), t(z1[s0:s1]), t(mean1[s0:s1]), t(rstd1[s0:s1]), t(gs1), t(gb1))
            dz1[s0:s1] = dz.numpy()
            cols += np.stack([dgs.numpy(), dgb.numpy(), dz.numpy().sum((0, 1))])
    return dh, dz1, dh.sum(1), cols[0], cols[1], cols[2]


def dgrad_x_emulated(dz1, w1, g, wres, T, cs, passes=3):
    """dgrad_x_stage: dx = conv_T(dz1, w1) + g @ wres^T (the same
    accumulators) or + g (after the ranks' sum)."""
    B, _, O = dz1.shape
    C = w1.shape[1]
    res = None if wres is None else (g.reshape(B * T, O), np.ascontiguousarray(wres.T)[None])
    dx = cluster_sum(dz1.reshape(B * T, O), flipped(w1), T, cs, 64, res, passes).reshape(B, T, C)
    return dx if wres is not None else dx + g


def block(C, O, T, B, seed):
    """Seeded inputs of one block, what its forward saved, and the closed
    forms of its backward (numpy)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(K, O, O, scale=(K * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    if C != O:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    g = f(B, T, O)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    args = [None if a.get(n) is None else torch.from_numpy(a[n]) for n in names]
    _, h, z1, z2, mean1, rstd1, mean2, rstd2 = fused_rtb_forward_saving_reference(*args)
    gt = torch.from_numpy(g)
    dz2, _, _ = gn_mish_backward_reference(gt, z2, mean2, rstd2, args[8], args[9])
    dh = conv1d_dgrad(dz2, args[6])
    dz1, dgs1, dgb1 = gn_mish_backward_reference(dh, z1, mean1, rstd1, args[4], args[5])
    dx = conv1d_dgrad(dz1, args[2]) + (gt @ args[10].t() if C != O else gt)
    closed = dict(dh=dh, dz1=dz1, dtemb=dh.sum(1), dgs1=dgs1, dgb1=dgb1, db1=dz1.sum((0, 1)), dx=dx)
    saved = dict(dz2=dz2, z1=z1, mean1=mean1, rstd1=rstd1)
    return a, g, {k: v.numpy() for k, v in saved.items()}, {k: v.numpy() for k, v in closed.items()}


def emulate(a, g, saved, T, cs, passes=3):
    B, _, C = a["x"].shape
    nt = _build.plan_backward(B, T, C, a["w2"].shape[1], 8, proj=C != a["w2"].shape[1]).nt_d2
    dh, dz1, dtemb, dgs1, dgb1, db1 = dgrad_gn_emulated(
        saved["dz2"], a["w2"], saved["z1"], saved["mean1"], saved["rstd1"], a["gs1"], a["gb1"], T,
        cs, nt, passes)
    dx = dgrad_x_emulated(dz1, a["w1"], g, a.get("wres"), T, cs, passes)
    return dict(dh=dh, dz1=dz1, dtemb=dtemb, dgs1=dgs1, dgb1=dgb1, db1=db1, dx=dx)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("C,O,T,B,cs", [
    (24, 64, 24, 19, 4), (64, 64, 24, 17, 2), (32, 64, 12, 37, 1), (64, 64, 12, 33, 4),
    (16, 64, 3, 70, 2), (64, 64, 3, 130, 4), (24, 40, 5, 41, 2), (8, 16, 2, 100, 1),
    (48, 96, 12, 20, 2),
], ids=["T24-proj-cs4", "T24-id-cs2", "T12-proj-cs1", "T12-id-cs4", "T3-proj-cs2", "T3-id-cs4",
        "T5-odd-cs2", "T2-narrow-cs1", "T12-nt128-cs2"])
def test_emulated_dgrads_match_the_closed_forms(C, O, T, B, cs):
    """dh, dz1, dtemb, the first GroupNorm's dgs1, dgb1, db1 and dx of the
    emulated cluster split agree with the closed forms within 1e-4 of their
    largest entry: projection and identity residuals, ragged last tiles
    (ranks with no samples included), position-major tiles at T <= 3, and
    the N tile of 128 where 64 channels hold no whole groups (O = 96: 12 a
    group)."""
    if O == 96:
        assert _build.plan_backward(B, T, C, O, 8, proj=True).nt_d2 == 128
    a, g, saved, closed = block(C, O, T, B, seed=C * T + B)
    got = emulate(a, g, saved, T, cs)
    for name, want in closed.items():
        assert got[name].shape == want.shape, name
        assert _rel(got[name], want) <= TOL, name


@pytest.mark.parametrize("C,O,T", [(16, 32, 24), (32, 32, 12), (8, 16, 3), (64, 64, 3)],
                         ids=["proj-T24", "identity-T12", "proj-T3", "identity-T3"])
def test_emulated_dgrads_match_jax_custom_vjp(C, O, T):
    """dx and dtemb of the emulation, with the plan's cluster sizes, against
    the JAX package's _fused_rtb_cv_bwd on the same numpy inputs, within
    1e-4."""
    B = 30
    a, g, saved, _ = block(C, O, T, B, seed=C + O + T)
    plan = _build.plan_backward(B, T, C, O, 8, proj=C != O, num_sms=132)
    dh, dz1, dtemb, *_ = dgrad_gn_emulated(saved["dz2"], a["w2"], saved["z1"], saved["mean1"],
                                           saved["rstd1"], a["gs1"], a["gb1"], T, plan.cs_d2)
    dx = dgrad_x_emulated(dz1, a["w1"], g, a.get("wres"), T, plan.cs_d1)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    res = tuple(None if a.get(n) is None else jnp.asarray(a[n]) for n in names)
    cot = _fused_rtb_cv_bwd(8, 1e-5, 32, res, jnp.asarray(g))
    for got, want in ((dx, np.asarray(cot[0])), (dtemb, np.asarray(cot[1]))):
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL


def test_emulated_cluster_sum_repeats_and_single_tf32_misses():
    """The ranks' partials are summed in a fixed order, so the split repeats
    bit for bit; any cluster size meets the bound, where one tf32 pass
    (big x big only) misses it by more than ten times the 3xTF32 error."""
    a, g, saved, closed = block(24, 64, 12, 40, seed=11)
    first, again = emulate(a, g, saved, 12, 4), emulate(a, g, saved, 12, 4)
    for name in first:
        assert np.array_equal(first[name], again[name]), name
    errs = {cs: _rel(emulate(a, g, saved, 12, cs)["dx"], closed["dx"]) for cs in (1, 2, 4)}
    assert max(errs.values()) <= TOL
    one = _rel(emulate(a, g, saved, 12, 2, passes=1)["dx"], closed["dx"])
    assert one > TOL and one > 10 * max(errs.values())


def test_staged_box_marks_what_the_kernel_never_loads():
    """The emulation's staged box: the tile's live rows and the rank's
    channels hold the cotangent (zero past the tensor's channels), the rest
    is NaN, which the emulated masks keep out of every accumulator."""
    d = np.arange(40 * 12, dtype=np.float32).reshape(40, 12)
    box = staged_box(d, 24, 10, 1, 2)
    assert np.array_equal(box[:10, 8:12], d[24:34, 8:12])
    assert not box[:10, 12:16].any()
    assert np.isnan(box[10:]).all() and np.isnan(box[:, :8]).all()
    assert rank_chunks(64, 0, 4, 2) == (0, 2) and rank_chunks(64, 3, 4, 2) == (6, 8)
    assert rank_chunks(24, 0, 2, 2) == (0, 2) and rank_chunks(24, 1, 2, 2) == (2, 3)
    assert rank_chunks(8, 0, 2, 2) == (0, 0) and rank_chunks(8, 1, 2, 2) == (0, 1)


ROW_OF_K = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # wgrad's K positions: t -> row 2t, t + 4 -> 2t + 1


def operand_writes(row0, nrows, R, T, n0, ncols, O):
    """write_wgrad_operand's loop (conv_backward.cuh) for one run of rows of
    one N tile: [((group q, channel o, K position), row written, or -1 for
    a zero of the padding)]."""
    p3 = T == 3
    Q = -(-R // 48) * 6 if p3 else -(-R // 8)
    rend = row0 + nrows
    rpad = (Q // 6 * 48 if p3 else Q * 8) if rend == R else rend
    cend = n0 + ncols
    cpad = -(-O // 64) * 64 if cend == O else cend
    units = 2 * (cpad - n0)
    q0 = row0 // 48 * 6 if p3 else row0 // 8
    n = (((rpad + 47) // 48 * 6) if p3 else (rpad + 7) // 8) - q0
    out = []
    for i in range(n * units):
        q, u = q0 + i // units, i % units
        c, kh, g = (u >> 4) * 8 + (u & 7), (u >> 3) & 1, q % 6
        r = q // 6 * 48 + 3 * (8 * (g & 1) + kh) + (g >> 1) if p3 else 8 * q + kh
        for k in range(4):
            row = r + (6 if p3 else 2) * k
            if row0 <= row < rpad:
                live = row < rend and n0 + c < cend
                out.append(((q, n0 + c, 4 * kh + k), row if live else -1))
    return out


@pytest.mark.parametrize("T,B,cs", [(3, 70, 2), (3, 100, 4), (24, 19, 4), (5, 41, 2), (3, 64, 1)],
                         ids=["T3-cs2", "T3-cs4", "T24-cs4", "T5-cs2", "T3-cs1"])
def test_operand_writes_of_the_ranks_cover_the_layout_once(T, B, cs):
    """dgrad_gn_stage's ranks write dz1 in wgrad's operand layout from their
    shares of a tile's samples, which at T = 3 may end inside a stage of 48
    rows: together they write every word of the layout once, each the row
    that the layout puts at its K position (zero past the rows and
    channels)."""
    O, S = 40, ROWS // T
    R = B * T
    seen = {}
    for rt in range(-(-B // S)):
        ns = min(S, B - rt * S)
        for q in range(cs):
            s0, s1 = rt * S + ns * q // cs, rt * S + ns * (q + 1) // cs
            if s1 > s0:
                for key, row in operand_writes(s0 * T, (s1 - s0) * T, R, T, 0, O, O):
                    assert key not in seen, key
                    seen[key] = row
    groups = -(-R // 48) * 6 if T == 3 else -(-R // 8)
    assert len(seen) == groups * 64 * 8
    for (q, o, kpos), row in seen.items():
        want = 48 * (q // 6) + 3 * (8 * (q % 6 % 2) + ROW_OF_K[kpos]) + q % 6 // 2 if T == 3 \
            else 8 * q + ROW_OF_K[kpos]
        assert row == (want if want < R and o < O else -1), (q, o, kpos)
