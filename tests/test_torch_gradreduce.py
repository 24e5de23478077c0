"""The backward's in-order sum of partials (``grad_reduce`` in
``cindm_tpu_torch/ops/csrc/conv_backward.cuh``), its plan and a numpy
emulation of its items on the CPU.

``_build.plan_reduce`` cuts a launch's jobs (wgrad's split gradients, then
the GroupNorm kernels' column partials) into a flat list of items, each a
run of whole float4 columns over all of a job's slices; a grid of at most
two CTAs an SM walks the items round-robin, an elected thread fetches each
item's slab into one of two ring stages as TMA boxes of up to 256 columns x
256 slices of the job seen as [S][n] (a run of slices at a time where the
slab overflows a stage or a box; zeros where a box reaches past the job),
and each thread adds its 4 columns' slices in order. The emulation below follows the items
and stages and is held bit for bit to the in-order sum, to ``np.sum``, and,
through the emulated wgrad partials and GroupNorm tiles, to the JAX
package's custom VJP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.ops.fused_rtb import _fused_rtb_cv_bwd
from cindm_tpu_torch.ops import _build, fused_rtb_forward_saving_reference, grad_reduce, grad_reduce_reference
from cindm_tpu_torch.ops.fused_conv_gn import conv1d_dgrad
from cindm_tpu_torch.tools.backward_profile import HEAD_SHAPE, RTB_SHAPES, reduce_jobs
from test_torch_gnbwd import epilogue_tiles, gn_tiles, pairs_emulated
from test_torch_wgrad import wgrad_emulated

F32 = np.float32
TOL = 1e-4  # of the JAX cotangent's largest entry, as the kernels are held on the card
# The other paths' backward shapes: the forward model's Conv1dBlocks (head
# backward) at horizon 24 and 2 (T down to 1, C up to 1,024) and the 1-body
# prior's C = 4 block, the horizon-70 direct model's T = 70 and T = 35 blocks.
CONV_SHAPES = [(8, 64, 24), (8, 64, 2), (64, 64, 2), (64, 128, 1), (128, 256, 1), (512, 512, 1),
               (1024, 512, 1), (512, 256, 1), (256, 128, 2), (128, 64, 2)]
RTB_OTHER = [(4, 64, 24), (8, 64, 70), (64, 64, 70), (64, 128, 35), (512, 512, 35), (1024, 512, 35),
             (128, 64, 35)]
TRAINING = [(C, O, T, 512, True) for C, O, T in RTB_SHAPES] + [(*HEAD_SHAPE, 512, False)]
OTHER = ([(C, O, T, B, False) for C, O, T in CONV_SHAPES for B in (32, 4)]
         + [(C, O, T, B, True) for C, O, T in RTB_OTHER for B in (32, 4)])


def plan_of(C, O, T, B, rtb):
    return _build.plan_backward(B, T, C, O, 8, proj=rtb and C != O, rtb=rtb)


def item_list(plan):
    """(job, first column, columns) of every item, in the launch's order."""
    return [(j, c0, min(w, n - c0)) for j, ((n, _), w) in enumerate(zip(plan.jobs, plan.widths))
            for c0 in range(0, n, w)]


def tma_box(src, n, S, c, s, bw, per):
    """A TMA box of per slices x bw columns of src seen as [S][n] at column c,
    slice s: zeros where it reaches past the tensor."""
    box = np.zeros((per, bw), F32)
    rows, cols = min(per, S - s), min(bw, n - c)
    box[:rows, :cols] = src.reshape(S, n)[s:s + rows, c:c + cols]
    return box


def reduce_emulated(plan, srcs):
    """The kernel's walk: CTA b takes items b, b + grid, ..; each item
    arrives a ring stage (a run of per slices) at a time as boxes of bw
    columns laid one after the other; a thread's 4 columns at box f // bw4,
    row r, column f % bw4 add the run's slices in order to v, from 0, one
    float32 add at a time. Returns each job's sum and the stages' byte
    counts (whole boxes)."""
    items = item_list(plan)
    outs = [np.full(n, np.nan, F32) for n, _ in plan.jobs]
    stages = []
    for b in range(plan.grid):
        for j, c0, w in items[b::plan.grid]:
            n, S = plan.jobs[j]
            per, bw = _build.reduce_run(S, plan.widths[j]), _build.reduce_box(plan.widths[j])
            v = np.zeros(w, F32)
            for s0 in range(0, S, per):
                ns = min(per, S - s0)
                stage = np.concatenate([tma_box(srcs[j], n, S, c, s0, bw, per).reshape(-1)
                                        for c in range(c0, c0 + w, bw)])  # the boxes, one after the other
                stages.append(stage.nbytes)
                f = np.arange(w // 4)
                at = (f // (bw // 4)) * per * bw + (f % (bw // 4)) * 4  # float offset of the thread's float4
                for r in range(ns):
                    row = stage[(at + r * bw)[:, None] + np.arange(4)].reshape(-1)
                    v = (v + row).astype(F32)
            outs[j][c0:c0 + w] = v
    return outs, stages


def in_order(src, S):
    v = np.zeros(src.size // S, F32)
    for row in src.reshape(S, -1):
        v = (v + row).astype(F32)
    return v


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("C,O,T,B,rtb", TRAINING + OTHER, ids=lambda v: str(v))
def test_plan_covers_every_column_once_in_boxes_tma_takes(C, O, T, B, rtb):
    """Every (job, column) in exactly one item; every TMA box within TMA's
    limits (at most 256 x 256, rows of whole 16 bytes, the job's slice rows
    16 bytes apart, no larger than the job) and on 128 bytes of its stage;
    every stage within the ring's stage bytes and two CTAs' shared memory
    within an SM's; the grid min(items, 264), so no CTA idles; the jobs the
    backward's launch lists (the C side's order); at batch 512 every launch
    at least 132 items."""
    plan = plan_of(C, O, T, B, rtb)
    rd = plan.reduce
    assert rd.jobs == tuple(reduce_jobs(plan, O, not rtb, rtb and C != O))
    assert 1 <= len(rd.jobs) <= _build.REDUCE_JOBS
    seen = [np.zeros(n, int) for n, _ in rd.jobs]
    for j, c0, w in item_list(rd):
        n, S = rd.jobs[j]
        seen[j][c0:c0 + w] += 1
        W = rd.widths[j]
        assert w % 4 == 0 and 4 <= w <= W <= min(n, _build.REDUCE_MAX_WIDTH)
        per, bw = _build.reduce_run(S, W), _build.reduce_box(W)
        assert 1 <= per <= min(S, 256) and 4 <= bw <= min(n, 256) and W % bw == 0
        assert (4 * n) % 16 == 0 and (4 * bw) % 16 == 0
        boxes = -(-w // bw)
        assert boxes * 4 * bw * per <= 4 * W * per <= _build.REDUCE_STAGE_BYTES
        assert boxes == 1 or (4 * bw * per) % 128 == 0
    assert all((s == 1).all() for s in seen)
    assert [i0 for i0 in rd.item0] == [sum(-(-n // w) for (n, _), w in zip(rd.jobs[:j], rd.widths[:j]))
                                       for j in range(len(rd.jobs))]
    assert rd.items == len(item_list(rd)) and rd.grid == min(rd.items, 2 * _build.H100_SMS) <= rd.items
    smem = _build.REDUCE_STAGES * _build.REDUCE_STAGE_BYTES + 8 * _build.REDUCE_STAGES
    assert 2 * smem <= _build.SMEM_MAX
    if B == 512:
        assert rd.items >= 132


def test_plan_without_weight_gradients_has_no_reduce():
    assert _build.plan_backward(512, 3, 512, 512, 8, proj=False, want_w=False).reduce is None


@pytest.mark.parametrize("C,O,T,B,rtb", TRAINING, ids=lambda v: str(v))
def test_emulated_items_are_the_in_order_sum(C, O, T, B, rtb):
    """At the training batch's 17 job lists, on seeded partials: the items,
    stage by stage, give the in-order sum bit for bit (ragged last items
    included) and np.sum within 1e-6 of its largest entry."""
    rd = plan_of(C, O, T, B, rtb).reduce
    rng = np.random.default_rng(C * 7 + O + T)
    srcs = [rng.standard_normal(n * S).astype(F32) for n, S in rd.jobs]
    got, stages = reduce_emulated(rd, srcs)
    assert max(stages) <= _build.REDUCE_STAGE_BYTES
    for g, src, (n, S) in zip(got, srcs, rd.jobs):
        assert np.array_equal(g, in_order(src, S))
        ref = src.reshape(S, n).sum(0, dtype=np.float64)
        assert _rel(g, ref) <= 1e-6


@pytest.mark.parametrize("jobs", [
    [(4, 1)], [(12, 5000)], [(2052, 3), (8, 7), (4100, 1)], [(16384, 2)] * 10,
    [(65536, 40), (64, 3000)],
], ids=["one-column", "runs-of-slices", "ragged", "ten-jobs", "wide-and-deep"])
def test_emulated_items_at_odd_job_lists(jobs):
    """One column group, slices beyond a TMA box (the slab a run of 256
    slices at a time, the last run's box zero past the slices), ragged last
    items, ten jobs at once, more items than CTAs: bit for bit the in-order
    sum, which grad_reduce's CPU path (the plain version) also gives."""
    rd = _build.plan_reduce(jobs)
    rng = np.random.default_rng(len(jobs))
    srcs = [rng.standard_normal(n * S).astype(F32) for n, S in jobs]
    got, stages = reduce_emulated(rd, srcs)
    assert max(stages) <= _build.REDUCE_STAGE_BYTES
    plain = grad_reduce([(torch.from_numpy(s), S) for s, (_, S) in zip(srcs, jobs)])
    for g, p, src, (_, S) in zip(got, plain, srcs, jobs):
        assert np.array_equal(g, in_order(src, S)) and np.array_equal(g, p.numpy())
    if jobs == [(12, 5000)]:
        assert _build.reduce_run(5000, rd.widths[0]) == 256 and len(stages) == 3 * 20


def test_plan_refuses_what_the_kernel_cannot_take():
    for jobs in ([(6, 2)], [], [(8, 2)] * 11, [(8, 0)]):
        with pytest.raises(ValueError):
            _build.plan_reduce(jobs)


def test_reference_adds_in_slice_order():
    """grad_reduce_reference is v = 0, then v + src[s] for s in order: equal
    bit for bit to the numpy in-order sum, not to the sum in reverse order."""
    rng = np.random.default_rng(5)
    src = (rng.standard_normal((64, 1000)) * np.logspace(0, 6, 64)[:, None]).astype(F32)
    got = grad_reduce_reference(torch.from_numpy(src.reshape(-1)), 64).numpy()
    assert np.array_equal(got, in_order(src, 64))
    assert not np.array_equal(got, in_order(np.ascontiguousarray(src[::-1]), 64))


@pytest.mark.parametrize("C,O,T,B", [(16, 32, 24, 30), (32, 32, 12, 40)], ids=["proj-T24", "identity-T12"])
def test_emulated_cotangents_through_the_items_match_jax_custom_vjp(C, O, T, B):
    """The block's weight, bias and GroupNorm cotangents as the backward
    makes them: wgrad's split partials (emulated) and the GroupNorm kernels'
    per-tile column partials (emulated), summed by the emulated items of the
    plan's reduce launch (splits > 1 here), against the JAX package's
    _fused_rtb_cv_bwd on the same numpy inputs, within 1e-4."""
    rng = np.random.default_rng(C + O + T + B)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(F32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(5, C, O, scale=(5 * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(5, O, O, scale=(5 * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    proj = C != O
    if proj:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    g = f(B, T, O)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    args = [None if a.get(n) is None else torch.from_numpy(a[n]) for n in names]
    _, h, z1, z2, mean1, rstd1, mean2, rstd2 = [v.numpy() for v in fused_rtb_forward_saving_reference(*args)]
    plan = _build.plan_backward(B, T, C, O, 8, proj=proj)
    assert max(plan.splits) > 1
    R = B * T
    # the last GroupNorm's backward (gn_mish_bwd), then dgrad_gn_stage's epilogue on dh
    dz2, cols2 = pairs_emulated(g, z2, mean2, rstd2, a["gs2"], a["gb2"])
    dh = conv1d_dgrad(torch.from_numpy(dz2), args[6]).numpy()
    dz1, cols1 = pairs_emulated(dh, z1, mean1, rstd1, a["gs1"], a["gb1"])

    def rows(cols, tiles):  # a partial row per tile: its samples' sums in order
        out = []
        for samples in tiles:
            row = np.zeros(cols.shape[1], F32)
            for b in samples:
                row = (row + cols[b]).astype(F32)
            out.append(row)
        return np.stack(out).reshape(-1)

    flat = lambda t: np.ascontiguousarray(t.reshape(R, -1))
    wjobs = [(flat(a["x"]), flat(dz1), 5), (flat(h), flat(dz2), 5)] + ([(flat(a["x"]), flat(g), 1)] if proj else [])
    whole, srcs = {}, []
    for q, ((act, d, taps), sp, sps) in enumerate(zip(wjobs, plan.splits, plan.sps)):
        out, parts = wgrad_emulated(act, d, T, taps, sp, sps)
        if sp > 1:
            srcs.append(parts.reshape(-1))  # the split's partials, split after split
        else:
            whole[q] = out  # an unsplit job writes its gradient itself
    kinds2 = cols2 if proj else cols2[:3]
    srcs += [rows(c, gn_tiles(plan, B)) for c in kinds2] + [rows(c, epilogue_tiles(plan, B)) for c in cols1[:3]]
    rd = plan.reduce
    assert [(s.size // S, S) for s, (_, S) in zip(srcs, rd.jobs)] == list(rd.jobs)
    sums, _ = reduce_emulated(rd, srcs)
    nsplit = sum(sp > 1 for sp in plan.splits[:len(wjobs)])
    it = iter(sums[:nsplit])
    wg = [whole[q] if q in whole else next(it).reshape(taps, act.shape[1], O)
          for q, (act, _, taps) in enumerate(wjobs)]
    got = {"w1": wg[0], "w2": wg[1], "gs2": sums[nsplit], "gb2": sums[nsplit + 1], "b2": sums[nsplit + 2]}
    k = nsplit + 3
    if proj:
        got.update(wres=wg[2][0], bres=sums[k])
        k += 1
    got.update(gs1=sums[k], gb1=sums[k + 1], b1=sums[k + 2])
    res = tuple(None if a.get(n) is None else jnp.asarray(a[n]) for n in names)
    cot = _fused_rtb_cv_bwd(8, 1e-5, 32, res, jnp.asarray(g))
    for name, val in got.items():
        want = np.asarray(cot[names.index(name)])
        assert val.shape == want.shape, name
        assert _rel(val, want) <= TOL, name
