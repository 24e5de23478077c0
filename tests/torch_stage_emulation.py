"""A numpy emulation of the port's forward stage kernel on its main loop
(``cindm_tpu_torch/ops/csrc/conv_gn_mish.cuh`` on ``stage_ring.cuh``),
shared by the CPU tests and the card tests. It imports no JAX.

A tile is 192 rows of whole samples x an N tile of nt channels. Its three
warpgroups hold 64 tile rows each: position-major at T = 3 (tile row t * 64
+ s, a warpgroup a position, whose window of 3 of the 5 taps reads the
three positions' 64-row blocks), row-major otherwise (``fwd_tile_rows``).
K streams through a ring: a slot holds one chunk of 8 input channels (the
projection's part two) as the TMA box of the tile's 192 rows, laid out
under the box's swizzle (``tma_box``, ``swizzled``), with zeros past the
tensor; at T = 3 the box's rows come position-major, the projection's too.
The producer warpgroup splits the box for 3xTF32 with round-to-nearest
(split_tf32) into a big and a small plane in the same swizzled order
(``split_box``). Per chunk and tap of each warpgroup's window, A is read
from the planes: at T = 3 and for the projection by descriptor, the 64 rows
of a whole block at its offset (``desc_rows``); otherwise each fragment row
shifted by the tap and zero outside its sample. B is the tap's weight
planes (tf32 big and small); the product is small*big + big*small +
big*big into the accumulator. ``order="chunks"`` reads A instead from the
earlier cp.async loop's layout, one padded [192][12] plane a chunk split
per fragment, so that the two orders can be held to each other bit for
bit.

The epilogue runs on the accumulator as the consumers' registers hold it
(``tile_stats``, ``stage_emulated``): z = acc + b; the GroupNorm statistics
in the kernel's fixed orders (each lane of a row's quad adds its columns of
a group, 8j + 2q + e, in column order; the quad's sums as (l0 + l1) + (l2 +
l3); a sample's rows in row order; the squares by fused multiply-add);
Mish's closed form as the kernel takes it; the 1x1 projection's product P
(its own accumulation from zero, in the conv's tile rows) added as
(Mish(y) + P) + bres. The accumulators (``parts``: the conv's, then the
projection's) are returned in natural row order, live rows only, so that
orders with different tile layouts compare.

Given a stage plan (``_build.plan_stage``), the split tail's tiles run as
the plan's parts: each part accumulates its chunks [c0, c1) from zero, and
the tile's conv accumulator is the parts' sum in part order
(``SplitTile``: finish_split's workspace and counter, in which the last
part to arrive sums them); the projection runs whole, as in a tile's first
part."""

import numpy as np

from cindm_tpu_torch.ops import _build
from torch_port_helpers import tf32_split

K = 5
ROWS = _build.TILE_ROWS


def tile_rows(S, ns, T, KW=None):
    """tile_rows<5, KW> of stage_ring.cuh for every tile row j: its natural
    row r (relative to the tile), whether it is live, which of the 5 taps land
    inside its sample, and the first tap of its warpgroup's window of KW. KW
    defaults to the dgrads' rule (a window of 3, position-major, at T <= 3)."""
    KW = KW or (3 if T <= 3 else K)
    j = np.arange(ROWS)
    if KW < K:
        t = j // S
        s = j - t * S
        live = (s < ns) & (t < T)
    else:
        t, s = j % T, j // T
        live = s < ns
    ok = np.stack([live & (t + k - 2 >= 0) & (t + k - 2 < T) for k in range(K)], 1)
    klo = [max(0, 2 - min((w * 64 + 63) // S, T - 1)) if KW < K else 0 for w in range(3)]
    return s * T + t, live, ok, klo, KW


def fwd_tile_rows(S, ns, T):
    """The forward stage's tile rows: position-major only at T = 3, where A
    comes by descriptor (conv_gn_mish.cuh's KW = 3 instances)."""
    return tile_rows(S, ns, T, 3 if T == 3 else K)


def swizzled(row, u, w, pitch):
    """Float index of (row, 16-byte unit u, word w) in a TMA box of
    ``pitch``-byte rows under the ``pitch``-byte swizzle (stage_ring.cuh)."""
    return row * (pitch // 4) + 4 * (u ^ ((row * pitch >> 7) & (pitch // 16 - 1))) + w


def tma_box(src, rows, c0, pitch):
    """A ring slot's TMA box: source rows ``rows`` (192 row indices of src
    [R, C], in box order) x channels c0 .. c0 + pitch / 4 - 1, flat, in
    swizzled order; zeros past the tensor."""
    R, C = src.shape
    n = pitch // 4
    gr, gc = np.asarray(rows)[:, None], c0 + np.arange(n)[None, :]
    val = np.where((gr < R) & (gc < C), src[np.minimum(gr, R - 1), np.minimum(gc, C - 1)], 0.0)
    flat = np.full(ROWS * n, np.nan, np.float32)
    flat[swizzled(np.arange(ROWS)[:, None], np.arange(n)[None, :] // 4, np.arange(n)[None, :] % 4, pitch)] = val
    assert not np.isnan(flat).any()  # the box is written whole
    return flat


def box_rows(row0, T, S, position_major):
    """The source rows of a conv box: the tile's natural rows row0 ..
    row0 + 191, or at T = 3 position-major (the three boxes of
    position_map: box row t * S + s is natural row row0 + s * T + t)."""
    j = np.arange(ROWS)
    return row0 + ((j % S) * T + j // S if position_major else j)


def split_box(box):
    """ring_split: the box's big and small planes, element by element."""
    return tf32_split(box)


def desc_rows(planes, row, ch, pitch):
    """What a descriptor at box row ``row``, chunk ``ch`` reads of each
    plane: 64 rows x 8 inputs, through the swizzle."""
    i, k = np.arange(64)[:, None], np.arange(8)[None, :]
    idx = swizzled(row + i, 2 * ch + k // 4, k % 4, pitch)
    return [pl[idx] for pl in planes]


def ring_gemm(src, wk, row0, nrows, rows, nt, taps, order="ring", T=1, chunks=None):
    """One part of K for one tile into a [192, nt] accumulator (tile rows):
    src [R, Cin] the part's input, wk [taps, Cin, nt] the N tile's weights
    (channels past O zero), ``rows`` the conv's ``fwd_tile_rows`` (the
    projection, taps = 1, runs in the conv's registers: its rows are the
    conv's, position-major at T = 3). The ring's slots (``order="ring"``)
    or the earlier loop's chunks (``"chunks"``); ``chunks`` = (c0, c1): a
    split tile's part, its chunks c0 .. c1 - 1 only (default all)."""
    r, live, ok, klo, KW = rows
    cin = src.shape[1]
    nch = -(-cin // 8)
    wpad = np.zeros((taps, nch * 8, nt), np.float32)
    wpad[:, :cin] = wk
    wb, wsm = tf32_split(wpad)
    ch_slot = 1 if taps == K else _build.PROJ_CHUNKS
    pitch = 32 * ch_slot
    desc = taps == 1 or KW < K  # A by descriptor: the projection, the conv at T = 3
    acc = np.zeros((ROWS, nt), np.float32)
    cols = np.arange(8)[None, :]
    c0, c1 = chunks or (0, nch)
    for c in range(c0, min(c1, nch), ch_slot):  # a ring slot
        if order == "ring":
            planes = split_box(tma_box(src, box_rows(row0, T, ROWS // T, KW < K), 8 * c, pitch))
        for ch in range(min(ch_slot, nch - c)):
            cc = slice(8 * (c + ch), 8 * (c + ch) + 8)
            if order == "chunks":  # the cp.async plane: live rows of the tile, channels < Cin
                plane = np.zeros((ROWS, 12), np.float32)
                hi = min(cin, 8 * (c + ch) + 8)
                plane[:nrows, :hi - 8 * (c + ch)] = src[row0:row0 + nrows, 8 * (c + ch):hi]
            for wg in range(3):
                j = slice(64 * wg, 64 * wg + 64)
                for u, k in enumerate([0] if taps == 1 else range(klo[wg], klo[wg] + KW)):
                    if order == "ring" and desc:  # whole 64-row blocks: position u, or the warpgroup's rows
                        ab, asm = desc_rows(planes, 64 * (wg if taps == 1 else u), ch, pitch)
                    else:
                        m = live[j] if taps == 1 else ok[j, k]
                        src_row = np.where(m, r[j] + (0 if taps == 1 else k - 2), 0)[:, None]
                        if order == "ring":  # the fragments from the planes, zero outside the sample
                            idx = swizzled(src_row, 2 * ch + cols // 4, cols % 4, pitch)
                            ab, asm = (np.where(m[:, None], pl[idx], 0.0).astype(np.float32)
                                       for pl in planes)
                        else:
                            ab, asm = tf32_split(np.where(m[:, None], plane[src_row, cols], 0.0))
                    acc[j] += asm @ wb[k, cc] + ab @ wsm[k, cc] + ab @ wb[k, cc]
    return acc


def kernel_mish(v):
    """mish() of conv_gn_mish.cuh: v * n / (n + 2), n = e (e + 2), e = exp(min(v, 20))."""
    v = np.asarray(v, np.float32)
    e = np.exp(np.minimum(v, np.float32(20.0)))
    n = e * (e + np.float32(2.0))
    return (v * (n / (n + np.float32(2.0)))).astype(np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to fp32 (the product exact in fp64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def tile_stats(zt, ns, T, og, gpt, eps):
    """The epilogue's GroupNorm statistics of one tile from z [ns * T, nt]
    (the tile's live rows, natural order): (mean, rstd) [ns, gpt] in the
    kernel's orders. row_group_sums: lane q of a row's quad adds its columns
    8j + 2q + e of each group in (j, e) order from 0, the squares (z -
    mean)^2 by fused multiply-add; the row's sum is (l0 + l1) + (l2 + l3).
    pair_stats: a sample's T rows added in row order from 0, divided by the
    group's n = T * og; rstd = 1 / sqrt(var + eps)."""
    nrows, nt = zt.shape
    n = np.float32(T * og)

    def rows_sum(mean):
        lanes = np.zeros((nrows, 4, gpt), np.float32)
        for j in range(nt // 8):
            for e in range(2):
                for q in range(4):
                    c = 8 * j + 2 * q + e
                    g = c // og
                    if g >= gpt:
                        continue
                    v = zt[:, c]
                    if mean is None:
                        lanes[:, q, g] = lanes[:, q, g] + v
                    else:
                        d = v - mean[np.arange(nrows) // T, g]
                        lanes[:, q, g] = _fma(d, d, lanes[:, q, g])
        return (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])

    def pairs(psum):
        acc = np.zeros((ns, gpt), np.float32)
        for t in range(T):
            acc = acc + psum[t::T]
        return (acc / n).astype(np.float32)

    mean = pairs(rows_sum(None))
    var = pairs(rows_sum(mean))
    return mean, (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(np.float32)


class SplitTile:
    """finish_split of stage_ring.cuh for one split tile of ``parts``
    parts, on numpy: the tile's workspace slots and arrival counter. A part
    stores its partial sums in its slot and counts itself in; the one that
    finds the counter at parts - 1 is last: it resets the counter to 0 and
    sums the slots in part order (part 0's own accumulator where it is part
    0, equal to its slot), the others get None."""

    def __init__(self, parts):
        self.slots = [None] * parts
        self.counter = 0

    def arrive(self, part, acc):
        self.slots[part] = np.array(acc, np.float32)
        old, self.counter = self.counter, self.counter + 1
        if old != len(self.slots) - 1:
            return None
        self.counter = 0
        total = np.array(acc if part == 0 else self.slots[0], np.float32)
        for q in range(1, len(self.slots)):
            total = (total + self.slots[q]).astype(np.float32)
        return total


def split_sum(partials, arrival=None):
    """The accumulator a split tile's finisher sums from ``partials`` (in
    part order) when the parts arrive in ``arrival`` (default part order)."""
    tile = SplitTile(len(partials))
    done = [tile.arrive(q, partials[q]) for q in (arrival or range(len(partials)))]
    finished = [d for d in done if d is not None]
    assert len(finished) == 1 and done[-1] is not None and tile.counter == 0
    return finished[0]


def stage_emulated(x, w, b, gs, gb, nt, G=8, eps=1e-5, temb=None, xres=None, wres=None, bres=None,
                   order="ring", plan=None):
    """One launch of the stage over x [B, T, C], w [5, C, O]: (out, z, mean,
    rstd, parts), ``parts`` the accumulators of every tile and part (conv,
    then the projection's), natural rows of the live samples,
    row tile by row tile. ``temb`` adds after Mish; ``xres`` alone is the
    identity residual, with ``wres`` and ``bres`` the projection's input.
    ``plan``: the launch's stage plan, whose split tail's tiles run as its
    parts (the conv accumulator their sum in part order); None: every tile
    whole."""
    B, T, C = x.shape
    O = w.shape[2]
    og = O // G
    S = ROWS // T
    x2 = x.reshape(B * T, C)
    z = np.zeros((B * T, O), np.float32)
    out = np.zeros((B * T, O), np.float32)
    mean = np.zeros((B, G), np.float32)
    rstd = np.zeros((B, G), np.float32)
    parts = []
    for rt in range(-(-B // S)):
        ns = min(S, B - rt * S)
        row0, nrows = rt * S * T, ns * T
        rows = fwd_tile_rows(S, ns, T)
        live_r = rows[0][rows[1]]  # the natural row of each live tile row
        for n0 in range(0, O, nt):
            ncols = min(nt, O - n0)
            gpt = ncols // og
            wk = np.zeros((K, C, nt), np.float32)
            wk[..., :ncols] = w[..., n0:n0 + ncols]
            item = rt // plan.cluster * plan.grid[1] + n0 // nt if plan else 0
            ranges = plan.item_parts(item) if plan else [None]
            acc = ring_gemm(x2, wk, row0, nrows, rows, nt, K, order, T, ranges[0])
            if len(ranges) > 1:
                acc = split_sum([acc] + [ring_gemm(x2, wk, row0, nrows, rows, nt, K, order, T, c)
                                         for c in ranges[1:]])
            tile = np.zeros((nrows, nt), np.float32)
            tile[live_r] = acc[rows[1]]
            parts.append(tile)
            zt = tile.copy()
            zt[:, :ncols] += b[n0:n0 + ncols]
            z[row0:row0 + nrows, n0:n0 + ncols] = zt[:, :ncols]
            m, r = tile_stats(zt, ns, T, og, gpt, eps)
            b0, g0 = rt * S, n0 // og
            mean[b0:b0 + ns, g0:g0 + gpt], rstd[b0:b0 + ns, g0:g0 + gpt] = m, r
            s_of = np.arange(nrows) // T
            grp = np.minimum(np.arange(ncols) // og, gpt - 1)
            y = (zt[:, :ncols] - m[s_of][:, grp]) * r[s_of][:, grp] * gs[n0:n0 + ncols] + gb[n0:n0 + ncols]
            act = kernel_mish(y)
            if wres is not None:  # the projection's product, in the conv's tile rows
                wr = np.zeros((1, wres.shape[0], nt), np.float32)
                wr[0, :, :ncols] = wres[:, n0:n0 + ncols]
                pacc = ring_gemm(xres.reshape(B * T, -1), wr, row0, nrows, rows, nt, 1, order, T)
                ptile = np.zeros((nrows, nt), np.float32)
                ptile[live_r] = pacc[rows[1]]
                parts.append(ptile)
                res = (act + ptile[:, :ncols]) + bres[n0:n0 + ncols]
            else:
                res = act
                if temb is not None:
                    res = res + temb[b0 + s_of, n0:n0 + ncols]
                if xres is not None:
                    res = res + xres.reshape(B * T, -1)[row0:row0 + nrows, n0:n0 + ncols]
            out[row0:row0 + nrows, n0:n0 + ncols] = res
    return out.reshape(B, T, O), z.reshape(B, T, O), mean, rstd, parts


def block_emulated(a, nt, order="ring", plans=(None, None)):
    """The fused ResidualTemporalBlock as its two stage launches compute it:
    (out, h, z1, z2, parts of both launches); ``plans``: each launch's plan
    (its split tail's tiles run as parts), or None (every tile whole)."""
    h, z1, _, _, p1 = stage_emulated(a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"], nt, temb=a["temb"],
                                     order=order, plan=plans[0])
    out, z2, _, _, p2 = stage_emulated(h, a["w2"], a["b2"], a["gs2"], a["gb2"], nt, xres=a["x"],
                                       wres=a.get("wres"), bres=a.get("bres"), order=order, plan=plans[1])
    return out, h, z1, z2, p1 + p2
