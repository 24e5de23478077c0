"""The forward stage on the shared main loop (``cindm_tpu_torch/ops/csrc/
conv_gn_mish.cuh`` on ``stage_ring.cuh``), checked on the CPU.

The stage runs persistent clusters of two CTAs (one where there is one row
tile), at most one CTA an SM, each cluster walking the plan's (row-tile
pair, N tile) items in a fixed order; in each CTA a producer warp fills a
ring of one-chunk slots (a TMA box of the tile's 192 rows, and half of the
slot's weight blocks multicast to both CTAs), three more warps split each
box into tf32 big and small planes, and three consumer warpgroups run the
wgmmas. Here the plan (``_build.plan_stage``) is held to the rules that
walk and ring need at every shape the denoiser and the smoke's other paths
launch and at the batches that leave an odd count of row tiles, the N-tile
rule to its choices at batch 5,376, and a numpy emulation of the loop
(``torch_stage_emulation``: A from the split planes, by descriptor at
T = 3) to the JAX package's ``fused_rtb`` and ``fused_conv1d_gn_mish`` and,
bit for bit, to the earlier loop's order. The split tail (the items past a
launch's last full wave, cut by K chunks into one range a cluster, the
last part of a tile to arrive finishing it) is held to its rules: every
chunk of every tile once, one first part a tile (the projection's), the
busiest cluster within one chunk of the mean, the finisher's sum the same
bits in every arrival order, and the emulated split stage to JAX."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish as jax_cgm
from cindm_tpu.ops.fused_rtb import fused_rtb as jax_fused_rtb
from cindm_tpu_torch.ops import _build
from cindm_tpu_torch.tools import stage_ablation
from torch_stage_emulation import block_emulated, split_sum, stage_emulated

TOL = 1e-4  # the kernels' limit against their plain versions: max abs and max error / max |ref|
K = 5
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
BATCHES = (1, 5, 500, 512, 5376)
STAGE_RING = (_build.CSRC / "stage_ring.cuh").read_text()
CONV_GN_MISH = (_build.CSRC / "conv_gn_mish.cuh").read_text()


def check_split(plan):
    """The split tail's rules: every chunk of every (row tile, N tile) runs
    once over the walks; a tile's parts are numbered 0 .. parts - 1, each
    once, in chunk order, none shorter than SPLIT_MIN_CHUNKS, at most
    max_parts; part 0 (the one that runs the projection) starts at chunk 0;
    whole tiles are one part of every chunk. Returns each cluster's chunks."""
    cs, nch = plan.cluster, plan.chunks
    runs, load = {}, []
    for q in range(0, plan.ctas, cs):
        load.append(sum(c1 - c0 for _, _, c0, c1, _, _ in plan.walk(q)))
        # the tail's parts, the last item first: an item's start first, the
        # range's first item's end last (its finisher, if any, finishes it
        # last); with the projection in range order, part 0 (which runs it) last
        nw = len(range(q // cs, plan.whole, plan.ctas // cs))
        for proj in (False, True):
            tail = plan.walk(q, proj)[nw:]
            items = [rt // cs * plan.grid[1] + nti for rt, nti, *_ in tail]
            assert items == sorted(items, reverse=not proj)
            if len(tail) > 1:
                assert tail[-1 if proj else 0][2] == 0 and tail[0 if proj else -1][3] == nch
            assert sorted(tail) == sorted(plan.walk(q)[nw:])
        for rt, nti, c0, c1, part, parts in (w for r in range(cs) for w in plan.walk(q + r)):
            runs.setdefault((rt, nti), []).append((part, parts, c0, c1))
    tiles = [(r, n) for r in range(-(-plan.grid[0] // cs) * cs) for n in range(plan.grid[1])]
    assert sorted(runs) == tiles
    split = 0
    for (rt, nti), got in runs.items():
        got.sort()
        parts = got[0][1]
        assert [g[0] for g in got] == list(range(parts)) and all(g[1] == parts for g in got)
        assert [(g[2], g[3]) for g in got] == plan.item_parts(rt // cs * plan.grid[1] + nti)
        assert got[0][2] == 0 and got[-1][3] == nch  # the projection's part first, K to its end
        assert all(got[i][3] == got[i + 1][2] for i in range(parts - 1))  # each chunk once
        assert all(c1 - c0 >= _build.SPLIT_MIN_CHUNKS for _, _, c0, c1 in got)
        assert parts <= plan.max_parts
        split += parts > 1
    assert plan.max_parts == max(len(plan.item_parts(i)) for i in range(plan.items))
    # the tail's tiles of both ranks (a tail item whose chunks fall in one range runs whole)
    assert split == cs * sum(len(plan.item_parts(i)) > 1 for i in range(plan.whole, plan.items))
    assert all(len(plan.item_parts(i)) == 1 for i in range(plan.whole))
    assert plan.work_bytes == plan.tail * plan.max_parts * cs * 192 * plan.n_tile * 4
    assert plan.counters == plan.tail * cs
    return load


def check_plan(B, T, C, O):
    """The rules the persistent walk, the ring and the launch's own check
    need of one stage's plan."""
    G = 8
    plan = _build.plan_stage(B, T, C, O, G)
    nt, og = plan.n_tile, O // G
    # the walk (conv_gn_mish_stage: cluster q of ctas / cs takes whole items
    # i = q, q + clusters, .. below plan.whole, then its range of the split
    # tail's chunks; its rank r row tile cs * (i / N tiles) + r and N tile
    # i % N tiles) covers every (row tile, N tile, chunk) once, at most one
    # CTA an SM; the only row tiles past the last are the partners of an odd
    # last one
    cs = plan.cluster
    assert cs == (2 if plan.grid[0] > 1 else 1)
    assert plan.ctas % cs == 0 and plan.ctas <= _build.H100_SMS
    clusters = _build.H100_SMS // cs
    assert (plan.tail, plan.tail_clusters, plan.max_parts) == _build.stage_split(plan.items, plan.chunks, clusters)
    assert plan.ctas == cs * min(clusters, max(plan.whole, plan.tail_clusters))
    assert plan.whole % clusters == 0 or plan.tail == 0  # whole items fill whole waves where there is a tail
    assert plan.chunks == -(-C // 8)
    check_split(plan)
    walked = [w[:2] for q in range(plan.ctas) for w in plan.walk(q)]
    idle = {w for w in walked if w[0] >= plan.grid[0]}
    assert len(idle) == (plan.grid[0] % cs and plan.grid[1]) and all(r == plan.grid[0] for r, _ in idle)
    for q in range(0, plan.ctas, cs):  # the CTAs of a cluster walk the same parts in step
        walks = [plan.walk(q + r) for r in range(cs)]
        assert all([(x[0] - r, *x[1:]) for x in w] == walks[0] for r, w in enumerate(walks))
    # shared memory: the C side's stage_smem_bytes restated from its parts:
    # the ring, nothing over it or beside it but the epilogue's rows' sums
    # [192][groups] and (mean, rstd) per (sample, group), then the barriers
    box = 192 * 32  # one chunk's rows, 32 bytes each
    slot = -(-(2 * box + 2 * K * (nt // 8) * 256) // 1024) * 1024  # box, small plane, weight blocks
    assert _build.fwd_ring(nt)[1] == slot == {64: 32768, 128: 53248}[nt]
    gpt = min(O, nt) // og
    stages = {64: 6, 128: 4}[nt]
    assert _build.fwd_ring(nt)[0] == stages
    assert plan.smem_bytes == 1024 + stages * slot + 4 * 192 * gpt + 8 * plan.samples * gpt + 24 * stages + 16
    assert 4 * 192 * gpt <= 6144 and plan.smem_bytes <= _build.SMEM_MAX == 232448
    # every TMA box's row pitch (the conv's one chunk, the projection's
    # two) and every tensor's row pitch it reads (x, h, xres) are whole
    # 16-byte units, within the 128-byte swizzle's span; at T = 3 the
    # position-major boxes are 64 samples of one position
    pch = _build.PROJ_CHUNKS
    assert all(32 * c % 16 == 0 and 32 * c <= 128 for c in (1, pch))
    assert all(4 * c % 16 == 0 for c in (C, O))
    assert T != 3 or plan.samples == 64
    # a projection slot (its box, small plane and pch blocks of one tap) fits a slot
    assert 2 * 192 * 32 * pch + pch * 2 * (nt // 8) * 256 <= slot
    # every bulk copy (a slot's weight blocks, of 5 taps or of the
    # projection's 1), each half a multicast moves and its source offset
    # are whole 16-byte units
    nch = -(-C // 8)
    for taps, per in ((K, 1), (1, pch)):
        block = 2 * taps * (nt // 8) * 256
        for c in range(0, nch, per):
            size = min(per, nch - c) * block
            assert size % 32 == 0 and (c * block) % 16 == 0 and (size // 2) % 16 == 0
    assert plan.weight_bytes(C) % 16 == 0 and plan.weight_bytes(C, K=1) % 16 == 0
    return plan


def _plans():
    for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
        for B in BATCHES:
            yield C, O, T, B


@pytest.mark.parametrize("C,O,T,B", list(_plans()), ids=lambda v: str(v))
def test_stage_plan_walks_every_tile_once_within_the_card(C, O, T, B):
    plan = check_plan(B, T, C, O)
    second = check_plan(B, T, O, O)  # a block's second stage: its own K, so its own split
    # the tiles (and so the staged weights' N tile) do not depend on C
    assert (second.samples, second.n_tile, second.smem_bytes, second.grid, second.cluster) == (
        plan.samples, plan.n_tile, plan.smem_bytes, plan.grid, plan.cluster)


@pytest.mark.parametrize("B", [5376, 5000, 512])
@pytest.mark.parametrize("C,O,T", RTB_SHAPES[:8] + RTB_SHAPES[10:] + [HEAD_SHAPE], ids=lambda v: str(v))
def test_cluster_pairs_walk_every_tile_once(C, O, T, B):
    """Under cluster pairing every (row tile, N tile) runs once, in a
    cluster of 2; at batch 5,000 every T leaves an odd count of row tiles
    (625, 313, 157, 79), whose last tile's partner only keeps the ring
    going, one such item an N tile."""
    plan = check_plan(B, T, C, O)
    assert plan.cluster == 2
    if B == 5000:
        assert plan.grid[0] == {24: 625, 12: 313, 6: 157, 3: 79}[T]
        assert len({w[:2] for q in range(plan.ctas) for w in plan.walk(q) if w[0] >= plan.grid[0]}) == plan.grid[1]


def test_one_row_tile_runs_without_a_partner():
    for B, T in ((8, 24), (64, 3), (1, 12)):
        plan = check_plan(B, T, 64, 64)
        assert plan.grid[0] == 1 and plan.cluster == 1
        # its few tiles split by K chunks over CTAs of their own (8 chunks of 64 channels)
        assert plan.tail == plan.tiles and plan.ctas == plan.tiles * min(plan.chunks, _build.SPLIT_PARTS)


def test_stage_plan_at_the_smoke_s_other_paths_shapes():
    """The forward model's Conv1dBlocks at horizons 24 and 2 (batch 1,000,
    32 and 4) and the analysis path's fused-RTB blocks (chip_smoke's
    check_slice5_kernels lists them on any device)."""
    listed = chip_smoke.check_slice5_kernels(torch, torch.device("cpu"), False)
    conv = listed["forward_model_block_shapes"]
    shapes = [(C, O, T, b) for C, O, T in conv["h24"] + conv["h2"]
              for b in (chip_smoke.CEM_N, chip_smoke.BASELINE_BATCH, chip_smoke.DESIGN_BATCH)]
    shapes += [tuple(s) for s in listed["rtb_analysis_shapes"]]
    assert len(shapes) >= 10 and min(T for _, _, T, _ in shapes) == 1
    for C, O, T, B in shapes:
        check_plan(B, T, C, O)


def test_the_forward_profile_runs_the_smoke_s_design():
    """tools/forward_profile's design run is the smoke's flagship geometry."""
    from cindm_tpu_torch.tools import forward_profile

    assert forward_profile.DESIGN_ARGS == chip_smoke.DESIGN_ARGS
    assert (forward_profile.RECURRENCE, forward_profile.N_WINDOWS, forward_profile.N_PAIRS) == (
        chip_smoke.RECURRENCE, chip_smoke.N_WINDOWS, chip_smoke.N_PAIRS)


def test_n_tile_takes_the_fewer_waves_of_work_and_the_wide_tile_on_a_tie():
    def nt(C, O, T, B=5376):
        return _build.plan_stage(B, T, C, O, 8).n_tile
    # 84 cluster items of 128 channels on 66 clusters: 2 waves x 128 > 3
    # waves (168 items) x 64
    assert nt(512, 256, 3) == 64 and nt(256, 128, 6) == 64
    assert _build.plan_stage(5376, 3, 512, 256, 8).tiles == 336
    assert _build.plan_stage(5376, 3, 512, 256, 8).items == 168
    # a tie (168 items of 128, 3 waves, against 336 of 64, 6 waves): the wide tile
    assert nt(1024, 512, 3) == 128 and nt(512, 512, 3) == 128 and nt(64, 128, 12) == 128
    # one N tile of either width: the narrow one is less work
    assert nt(64, 64, 24) == 64
    # at the training batch every grid is one wave: the narrow tile
    assert nt(1024, 512, 3, B=512) == 64


def _stage_launches():
    """(C, O, T) of every stage launch of a denoiser forward: each block's
    two (the second is O -> O) and the head."""
    return sorted({s for C, O, T in RTB_SHAPES for s in ((C, O, T), (O, O, T))} | {HEAD_SHAPE})


@pytest.mark.parametrize("B", [5376, 512])
@pytest.mark.parametrize("C,O,T", _stage_launches(), ids=lambda v: str(v))
def test_busiest_cluster_is_within_one_chunk_of_the_mean(C, O, T, B):
    """At batch 5,376 (the flagship's fold) every stage launch's busiest
    cluster runs at most one chunk more than the mean of the card's 66
    clusters, and at the training batch (512: 16 or 32 items) every cluster
    gets work where the chunks allow it. 8 -> 64 at T = 24 has one chunk a
    tile: it stays whole (its items alone are within a chunk of the mean)."""
    plan = _build.plan_stage(B, T, C, O, 8)
    load = check_split(plan)
    clusters = _build.H100_SMS // plan.cluster
    load += [0] * (clusters - len(load))
    assert sum(load) == plan.items * plan.chunks
    assert max(load) <= plan.items * plan.chunks / clusters + 1, (plan, max(load))
    if plan.chunks == 1:
        assert C == 8 and plan.tail == 0 and plan.max_parts == 1
    else:
        assert plan.tail == plan.items % clusters > 0
    if B == 512:
        assert plan.items < clusters and plan.whole == (plan.items if plan.chunks == 1 else 0)
        assert plan.ctas == (plan.cluster * plan.items if plan.chunks == 1 else _build.H100_SMS)


def test_the_split_at_the_flagship_batch_and_its_workspace():
    """At 5,376: 14 of the 16 blocks' stages run 132 whole items (2 waves)
    and split 36 (the third), the 64-channel T = 24 stages 330 whole and 6
    split into 8 parts of one chunk; the workspace of the largest launch is
    the 36 items x 3 parts x 2 ranks of 192 x 128 floats."""
    p = _build.plan_stage(5376, 3, 512, 512, 8)
    assert (p.items, p.whole, p.tail, p.tail_clusters, p.max_parts, p.ctas) == (168, 132, 36, 66, 3, 132)
    assert p.work_bytes == 36 * 3 * 2 * 192 * 128 * 4 and p.counters == 72
    p = _build.plan_stage(5376, 24, 64, 64, 8)
    assert (p.items, p.whole, p.tail, p.tail_clusters, p.max_parts) == (336, 330, 6, 48, 8)
    assert all(len(p.item_parts(i)) == 8 for i in range(330, 336))
    assert _build.plan_stage(5376, 24, 8, 64, 8).tail == 0
    assert not _build.plan_stage(5376, 3, 512, 512, 8, split=False).tail  # the ablation's whole tiles


def test_compare_whole_tells_whole_tiles_from_split_ones():
    """tools/cotangent_hash --compare-whole: a z tile that differs counts as
    a whole tile's (and fails) only where the plan runs that tile whole."""
    from cindm_tpu_torch.tools import cotangent_hash

    key = "1:64,64,24@5376"
    plans = [_build.plan_stage(B, T, C, O, 8) for B, T, C, O in cotangent_hash.stage_shapes(key)]
    assert len(plans) == 2 and plans[0].tail == 6
    a = {key + ":tiles": {"samples": 8, "n_tile": 64, "sms": 132,
                          "z": [[str(t) for t in range(p.tiles)] for p in plans]}}
    split_tile = 2 * plans[0].whole  # row tile 660: rank 0 of the first tail item
    for changed, whole in ((split_tile, False), (3, True)):
        b = {key + ":tiles": {**a[key + ":tiles"], "z": [
            [t + "'" if i == changed else t for i, t in enumerate(z)] for z in a[key + ":tiles"]["z"]]}}
        res = cotangent_hash.compare_whole(a, b)
        assert res["whole_bit_identical"] == (not whole)
        assert res["split_differ" if not whole else "whole_differ"] == 2  # both stages' z
        assert res["split_equal"] + res["split_differ"] == 2 * 12  # 6 items x 2 ranks, both stages


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 9).flatmap(lambda n: st.tuples(st.permutations(list(range(n))),
                                                     st.integers(0, 2 ** 32 - 1))))
def test_every_arrival_order_gives_the_same_bits(order_and_seed):
    """finish_split's protocol on numpy (torch_stage_emulation.SplitTile):
    whichever part arrives last finishes the tile, exactly one does, the
    counter is back at 0, and its sum is the parts' in part order, the same
    bits for every arrival order (partials of magnitudes 1e-3 .. 1e3, where
    another order of the adds would round otherwise)."""
    order, seed = order_and_seed
    rng = np.random.default_rng(seed)
    partials = [(rng.standard_normal((8, 16)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32) for _ in order]
    want = partials[0]
    for v in partials[1:]:
        want = (want + v).astype(np.float32)
    np.testing.assert_array_equal(split_sum(partials, list(order)), want)


def test_the_plan_mirrors_the_c_constants():
    """_build's ring, cluster and shared-memory mirror restate stage_ring.cuh's
    and conv_gn_mish.cuh's: chunks and stages of the dgrads' ring and of the
    forward's, the forward's split planes, the cluster rule and the bytes'
    terms."""
    assert "template <int NT, int Stages = (NT == 64 ? 3 : 2), int Ch = (NT == 64 ? 2 : 1), size_t SlotBytes = 0," in STAGE_RING
    assert "static constexpr size_t kWOff = Planes ? 2 * kABytes : kABytes;" in STAGE_RING
    assert [_build.stage_ring(nt)[:2] for nt in (64, 128)] == [(2, 3), (1, 2)]
    assert "using ConvRing = StageRing<NT, NT == 64 ? kNarrowStages : kWideStages, 1, 0, true>;" in CONV_GN_MISH
    assert [_build.fwd_ring(nt)[0] for nt in (64, 128)] == [6, 4]
    body = re.search(r"stage_smem_bytes\(int nt, int samples, int groups_per_tile\) \{(.*?)\n\}",
                     CONV_GN_MISH, re.S).group(1)
    assert "const size_t ring = nt == 128 ? ConvRing<128>::kRingBytes : ConvRing<64>::kRingBytes;" in body
    assert "const int stages = nt == 128 ? kWideStages : kNarrowStages;" in body
    assert ("return 1024 + ring + 4 * size_t(kTileRows) * groups_per_tile + 8 * size_t(samples) * groups_per_tile +\n"
            "         24 * stages + 16;") in body
    # the kernel carves its shared memory as the bytes count it: the ring,
    # the rows' sums [192][groups], (mean, rstd) [samples][groups], the barriers
    assert "float* psum = reinterpret_cast<float*>(smem + R::kRingBytes);" in CONV_GN_MISH
    assert "float2* stats = reinterpret_cast<float2*>(psum + kTileRows * gmax);" in CONV_GN_MISH
    assert "f.full = smem_u32(stats + a.samples * gmax);" in CONV_GN_MISH
    assert f"constexpr int kWideStages = {_build.WIDE_STAGES};" in CONV_GN_MISH
    assert f"constexpr int kNarrowStages = {_build.NARROW_STAGES};" in CONV_GN_MISH
    assert f"constexpr int kProjChunks = {_build.PROJ_CHUNKS};" in CONV_GN_MISH
    assert f"stage_cluster(int row_tiles) {{ return row_tiles > 1 ? {_build.STAGE_CLUSTER} : 1; }}" in CONV_GN_MISH
    assert "*ctas = cs * (used < clusters ? used : clusters);" in STAGE_RING
    assert "return walk_plan(items, chunks, cs, sms, kSplitTail, split, ctas);" in CONV_GN_MISH
    assert ("if (s.cluster != a.cs || ctas != want || s.tail != a.split.tail || "
            "s.tail_clusters != a.split.tail_clusters ||\n      s.max_parts != a.split.max_parts)\n"
            "    return cudaErrorInvalidValue;") in CONV_GN_MISH
    # the split: its constants, the workspace's bytes (a slot of 192 x NT
    # floats per tail item, part and rank) and the launch's check of them
    assert f"constexpr int kSplitMinChunks = {_build.SPLIT_MIN_CHUNKS};" in STAGE_RING
    assert f"constexpr int kSplitParts = {_build.SPLIT_PARTS};" in STAGE_RING
    assert "constexpr bool kSplitTail = true;" in CONV_GN_MISH
    assert "return size_t(s.tail) * s.max_parts * cs * kTileRows * nt * 4;" in STAGE_RING
    assert "s.work_bytes < static_cast<long long>(stage_work_bytes(a.split, a.cs, nt))" in CONV_GN_MISH
    assert "s.n_counters < a.split.tail * a.cs" in CONV_GN_MISH
    assert "int range_of(int j, int total, int ranges) { return ((j + 1) * ranges - 1) / total; }" in STAGE_RING
    assert "int range_start(int k, int total, int ranges) { return k * total / ranges; }" in STAGE_RING
    assert [n for n, _ in _build.StageLaunch._fields_] == [
        "samples", "n_tile", "cluster", "smem_bytes", "ctas", "tail", "tail_clusters", "max_parts", "work",
        "counters", "work_bytes", "n_counters"]
    assert re.search(r"struct StageLaunch \{\s*int samples;.*?int n_tile;.*?int cluster;.*?int smem_bytes;.*?"
                     r"int ctas;.*?int tail, tail_clusters, max_parts;.*?float\* work;.*?int\* counters;.*?"
                     r"long long work_bytes;\s*int n_counters;\s*\};", CONV_GN_MISH, re.S)
    # no conv tile in shared memory, no z through device memory, no barrier
    # between a tile's epilogue and the next tile's loads; the only atomics
    # are a split tile's counter's (counted in with acquire and release at
    # the device's scope, reset by its finisher: finish_split, which the
    # resampling kernel's split shares)
    for gone in ("tile_bytes", "tile_stats", "kSpillZ", "kDeep"):
        assert gone not in CONV_GN_MISH, gone
    assert not re.search(r"\bepi\b|\bred\.", CONV_GN_MISH)
    code = re.sub(r"//[^\n]*", "", CONV_GN_MISH + STAGE_RING)
    assert re.findall(r"\batomic[A-Z]\w*\(|\batom\.[\w.]+", code) == ["atom.acq_rel.gpu.global.add.s32", "atomicExch("]
    assert not hasattr(_build, "DEEP_STAGES")
    # the stage reads staged planes; stage_weights is a launch of its own
    assert "launch_stage_weights" not in re.search(r"cudaError_t launch_stage\(.*", CONV_GN_MISH, re.S).group(0)
    # the split planes, the box's 16-byte units, the multicast's mask of both CTAs
    assert "constexpr int kSplitWarps = 3;" in STAGE_RING
    assert "multicast::cluster" in STAGE_RING and '"h"(static_cast<uint16_t>(0x3))' in STAGE_RING
    for gone in ("conv_gemm", "cp_async", "kXStages", "kXStride"):
        assert gone not in CONV_GN_MISH + STAGE_RING
    assert not hasattr(_build, "X_STAGES") and not hasattr(_build, "X_STRIDE")


def test_the_forward_splits_as_the_parent_s_consumers_did():
    """ring_split turns a box into planes with split_tf32 (round-to-nearest
    for both halves), and no forward consumer splits: the conv at T = 3 and
    the projection read A by descriptor, the conv at other T from the
    planes (Split::kPre); the dgrads keep Split::kFast."""
    split = re.search(r"void ring_split\(.*?\n\}", STAGE_RING, re.S).group(0)
    assert split.count("split_tf32(v.") == 4 and "split_tf32_fast" not in split
    assert "Split::kRna" not in CONV_GN_MISH and CONV_GN_MISH.count("Split::kPre") == 1
    assert "ring_consume_ss<CR, kConvK>" in CONV_GN_MISH and "ring_consume_ss<PR, 1>" in CONV_GN_MISH
    backward = (_build.CSRC / "conv_backward.cuh").read_text()
    assert "ring_consume_ss" not in backward and "ring_feed" not in backward
    assert backward.count("Split::kFast>") == 3


@pytest.mark.parametrize("name", list(stage_ablation.VARIANTS))
def test_every_ablation_pattern_occurs_once_in_its_source(name):
    srcs = {f: (_build.CSRC / f).read_text() for f in (stage_ablation.RING, stage_ablation.STAGE)}
    for f, old, _ in stage_ablation.VARIANTS[name]:
        assert srcs[f].count(old) == 1, (name, f, old)
    patched = stage_ablation.patched(name)
    assert (patched == srcs) == (name == "base")


def _block_args(C, O, B, T, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(x=f(B, T, C), temb=f(B, O), w1=f(K, C, O, scale=(K * C) ** -0.5), b1=f(O, scale=0.1),
             gs1=1 + f(O, scale=0.1), gb1=f(O, scale=0.1), w2=f(K, O, O, scale=(K * O) ** -0.5),
             b2=f(O, scale=0.1), gs2=1 + f(O, scale=0.1), gb2=f(O, scale=0.1))
    if C != O:
        a.update(wres=f(C, O, scale=C ** -0.5), bres=f(O, scale=0.1))
    return a


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= TOL and err / float(np.abs(want).max()) <= TOL, err


# (C, O, T, B, N tile): T = 24, 12, 6 and 3, with and without the projection,
# ragged last row tiles (8, 32 and 64 samples a tile), both N tiles (128:
# one chunk a stage, the projection's two-stage units), and the TPU
# kernel's own shapes under Pallas's interpreter (C, O multiples of 128)
BLOCK_CASES = [
    (16, 32, 24, 11, 64), (32, 32, 24, 8, 64), (16, 32, 6, 35, 64), (32, 32, 3, 70, 64),
    (64, 128, 3, 6, 128), (24, 64, 12, 17, 64), (128, 256, 24, 2, 128), (128, 128, 24, 2, 64),
    # the projection onto Mish(y) at T = 3 on N tiles of 64 (position-major
    # boxes of xres), at T = 6 and 12 on N tiles of 128; three row tiles,
    # the last ragged; groups of 3 channels (the register epilogue's
    # column-by-column sums)
    (16, 32, 3, 70, 64), (64, 128, 6, 40, 128), (32, 64, 12, 40, 128), (24, 24, 24, 19, 64),
]


@pytest.mark.parametrize("C,O,T,B,nt", BLOCK_CASES, ids=lambda v: str(v))
def test_emulated_ring_block_matches_jax_fused_rtb(C, O, T, B, nt):
    a = _block_args(C, O, B, T, seed=C + 3 * O + T + B)
    out, *_ = block_emulated(a, nt)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    want = np.asarray(jax_fused_rtb(*[None if a.get(n) is None else jnp.asarray(a[n]) for n in names],
                                    batch_tile=2 if B % 2 == 0 else 1, interpret=True))
    _close(out, want)


@pytest.mark.parametrize("C,O,T,B,nt", BLOCK_CASES, ids=lambda v: str(v))
def test_ring_order_equals_the_earlier_chunk_order_bit_for_bit(C, O, T, B, nt):
    """The ring's stages of whole chunks read A from swizzled TMA boxes; the
    earlier loop read it from one padded plane a chunk. The same values in
    the same chunk, tap and pass order give the same accumulators, so z,
    h and out are the same bits."""
    a = _block_args(C, O, B, T, seed=C + 3 * O + T + B)
    ring, chunks = block_emulated(a, nt, "ring"), block_emulated(a, nt, "chunks")
    for x, y in zip(ring[:4], chunks[:4]):
        np.testing.assert_array_equal(x, y)
    assert len(ring[4]) == len(chunks[4])
    for x, y in zip(ring[4], chunks[4]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("C,O,T,B", [(64, 64, 24, 9), (16, 32, 3, 70), (8, 64, 24, 3)],
                         ids=lambda v: str(v))
def test_emulated_ring_head_matches_jax_fused_conv1d_gn_mish(C, O, T, B):
    a = _block_args(C, O, B, T, seed=7 * C + O + T)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    out, z, *_ = stage_emulated(*args, 64)
    _close(out, np.asarray(jax_cgm(*map(jnp.asarray, args), batch_tile=1)))
    np.testing.assert_array_equal(z, stage_emulated(*args, 64, order="chunks")[1])


@pytest.mark.parametrize("C,O,T,B,nt", [(32, 128, 12, 17, 128), (16, 48, 6, 33, 64), (64, 64, 3, 130, 64)],
                         ids=lambda v: str(v))
def test_emulated_ring_head_at_both_n_tiles_matches_jax(C, O, T, B, nt):
    """The head's stage on an N tile of 128, with groups of 6 channels (the
    epilogue's column-by-column sums) and at T = 3 over three row tiles."""
    a = _block_args(C, O, B, T, seed=5 * C + O + T)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    out, z, *_ = stage_emulated(*args, nt)
    _close(out, np.asarray(jax_cgm(*map(jnp.asarray, args), batch_tile=1)))
    np.testing.assert_array_equal(out, stage_emulated(*args, nt, order="chunks")[0])


# Split plans at small shapes: a card of `sms` SMs (sms / 2 clusters)
# leaves a partial wave whose tiles split, with and without the projection,
# at T = 24, 12, 6 and 3, both N tiles, the odd last row tile's partner
# (B = 70 at T = 3: one pair) and ragged last tiles.
SPLIT_CASES = [  # C, O, T, B, sms
    (16, 32, 24, 11, 8), (32, 32, 3, 70, 8), (16, 32, 3, 70, 8), (64, 128, 6, 40, 8),
    (32, 128, 12, 90, 8), (24, 64, 12, 17, 6), (16, 48, 6, 100, 12),
]


def _split_plans(C, O, T, B, sms):
    plans = [_build.plan_stage(B, T, c, O, 8, num_sms=sms) for c in (C, O)]
    for p in plans:
        check_split(p)
    assert plans[0].n_tile == plans[1].n_tile and any(p.max_parts > 1 for p in plans), plans
    return plans


@pytest.mark.parametrize("C,O,T,B,sms", SPLIT_CASES, ids=lambda v: str(v))
def test_emulated_split_block_matches_jax_fused_rtb(C, O, T, B, sms):
    """The block's two launches with their split tails (each tile's parts
    summed in part order by its finisher) against the JAX package's
    fused_rtb under Pallas's interpreter, within the kernels' limit (1e-4
    max abs and max error / max |ref|); the whole tiles' z, h and out
    rows bit-identical to the emulation without a split."""
    a = _block_args(C, O, B, T, seed=2 * C + O + T + B)
    plans = _split_plans(C, O, T, B, sms)
    out, h, z1, z2, _ = block_emulated(a, plans[0].n_tile, plans=plans)
    names = ["x", "temb", "w1", "b1", "gs1", "gb1", "w2", "b2", "gs2", "gb2", "wres", "bres"]
    want = np.asarray(jax_fused_rtb(*[None if a.get(n) is None else jnp.asarray(a[n]) for n in names],
                                    batch_tile=2 if B % 2 == 0 else 1, interpret=True))
    _close(out, want)
    whole = block_emulated(a, plans[0].n_tile)
    p = plans[0]
    S = p.samples
    split_rows = {rt for rt, _, _, _, _, parts in (w for q in range(p.ctas) for w in p.walk(q)) if parts > 1}
    keep = np.ones(B, bool)
    for rt in split_rows:
        keep[rt * S:(rt + 1) * S] = False
    np.testing.assert_array_equal(z1[keep], whole[2][keep])  # the first launch's whole tiles
    assert not keep.all() or plans[0].max_parts == 1


@pytest.mark.parametrize("C,O,T,B,sms", [(64, 64, 24, 9, 8), (16, 48, 6, 100, 12), (64, 64, 3, 130, 8)],
                         ids=lambda v: str(v))
def test_emulated_split_head_matches_jax_fused_conv1d_gn_mish(C, O, T, B, sms):
    """The head's stage with a split tail against the JAX package's
    fused_conv1d_gn_mish, within the kernels' limit; two runs the same bits."""
    a = _block_args(C, O, B, T, seed=3 * C + O + T)
    args = [a["x"], a["w1"], a["b1"], a["gs1"], a["gb1"]]
    plan = _build.plan_stage(B, T, C, O, 8, num_sms=sms)
    assert plan.max_parts > 1
    out, z, *_ = stage_emulated(*args, plan.n_tile, plan=plan)
    _close(out, np.asarray(jax_cgm(*map(jnp.asarray, args), batch_tile=1)))
    np.testing.assert_array_equal(z, stage_emulated(*args, plan.n_tile, plan=plan)[1])


class _Stager:
    """A stand-in for the layout launch: records each call (``launches``,
    its jobs' (shape, N tile)) and each layout (``calls``), and returns w's
    values with the N tile appended, so that a stale entry shows."""

    def __init__(self):
        self.calls = []
        self.launches = []

    def __call__(self, jobs):
        made = [(tuple(w.shape), nt) for w, nt in jobs]
        self.calls += made
        self.launches.append(made)
        return [torch.cat([w.detach().reshape(-1).clone(), torch.tensor([float(nt)])]) for w, nt in jobs]


def _weight(seed, shape=(K, 8, 16)):
    return torch.nn.Parameter(torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)))


def _holds(planes, w):
    return torch.equal(planes[:-1], w.detach().reshape(-1))


@pytest.mark.parametrize("update", ["add_", "_foreach_add_", "load_state_dict"])
def test_staging_cache_restages_after_an_in_place_update(update):
    """Adam's _foreach_add_, a plain add_ and load_state_dict's copy_ bump
    the weight's version counter: its next use stages the new values, and
    the old version's planes go."""
    stage = _build.WeightStage(_Stager())
    w = _weight(0)
    first = stage(w, 64)
    assert stage(w, 64) is first and len(stage.stager.calls) == 1
    with torch.no_grad():
        if update == "add_":
            w.add_(1.0)
        elif update == "_foreach_add_":
            torch._foreach_add_([w], [torch.ones_like(w)])
        else:
            holder = torch.nn.Module()
            holder.w = w
            holder.load_state_dict({"w": 2 * w.detach()})
    again = stage(w, 64)
    assert len(stage.stager.calls) == 2 and again is not first and _holds(again, w)
    assert not _holds(first, w) and len(stage) == 1
    assert stage(w, 64) is again


def test_staging_cache_new_tensor_of_the_same_shape_stages_anew():
    stage = _build.WeightStage(_Stager())
    a, b = _weight(0), _weight(1)
    pa, pb = stage(a, 64), stage(b, 64)
    assert len(stage.stager.calls) == 2 and _holds(pa, a) and _holds(pb, b)
    c = torch.nn.Parameter(a.detach().clone())  # equal values, another tensor
    assert stage(c, 64) is not pa and len(stage.stager.calls) == 3


def test_staging_cache_entry_goes_when_its_tensor_is_freed():
    import gc

    stage = _build.WeightStage(_Stager())
    w = _weight(0)
    stage(w, 64)
    stage(w, 128)
    assert len(stage) == 2
    del w
    gc.collect()
    assert len(stage) == 0 and not stage._owners
    v = _weight(1)  # a tensor in its place (perhaps at its id and address) stages its own values
    assert _holds(stage(v, 64), v) and len(stage.stager.calls) == 3


def test_staging_cache_keeps_planes_per_n_tile():
    stage = _build.WeightStage(_Stager())
    w = _weight(0)
    p64, p128 = stage(w, 64), stage(w, 128)
    assert stage.stager.calls == [((K, 8, 16), 64), ((K, 8, 16), 128)]
    assert stage(w, 64) is p64 and stage(w, 128) is p128 and p64[-1] == 64 and p128[-1] == 128
    stage.clear()
    assert len(stage) == 0 and stage(w, 64) is not p64 and len(stage.stager.calls) == 3


def test_staging_cache_keys_a_view_on_the_tensor_it_views():
    """The block hands its 1x1 projection in as the view weight[0] of a
    [1, C, O] parameter, a new view every call: one entry, staged as K = 1."""
    stage = _build.WeightStage(_Stager())
    w = _weight(0, (1, 8, 16))
    first = stage(w[0], 64)
    assert stage(w[0], 64) is first and stage.stager.calls == [((1, 8, 16), 64)]
    with torch.no_grad():
        w.mul_(3.0)  # the view shares the parameter's version counter
    assert _holds(stage(w[0], 64), w)


@pytest.mark.parametrize("K_,C,O,nt", [(5, 12, 72, 64), (1, 40, 136, 128), (5, 8, 64, 128)],
                         ids=lambda v: str(v))
def test_stage_weights_reference_is_the_kernel_layout(K_, C, O, nt):
    """stage_weights' plain version against its index rule (conv_gn_mish.cuh:
    block (N tile, chunk), plane 2 tap + small, word n8 * 64 + q holds
    channel n8 * 8 + (q % 32) / 4 of input q / 32 * 4 + q % 4, zero past C
    or O) and split_tf32's halves; the CPU stager is this plain version and
    counts no launch."""
    from torch_port_helpers import tf32_split

    w = torch.from_numpy(np.random.default_rng(C + O).standard_normal((K_, C, O)).astype(np.float32))
    w[0, 0, 0], w[-1, -1, -1] = float("inf"), float("nan")
    got = _build.stage_weights_reference(w, nt)
    assert got.dtype == torch.int32 and got.numel() * 4 == _build.staged_weight_bytes(nt, C, O, K_)
    nch, plane = -(-C // 8), nt * 8
    i = np.arange(got.numel())
    b, rem = np.divmod(i, 2 * K_ * plane)
    tp, e = np.divmod(rem, plane)
    n8, q = np.divmod(e, 64)
    ntile, chunk = np.divmod(b, nch)
    o = ntile * nt + n8 * 8 + (q % 32) // 4
    c = chunk * 8 + (q // 32) * 4 + q % 4
    inside = (o < O) & (c < C)
    with np.errstate(invalid="ignore"):  # inf - inf in the split of the inf entry
        big, small = (h.view(np.uint32) for h in tf32_split(w.numpy()))
    want = np.where(tp % 2, small[tp // 2, np.minimum(c, C - 1), np.minimum(o, O - 1)],
                    big[tp // 2, np.minimum(c, C - 1), np.minimum(o, O - 1)])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.where(inside, want, 0))
    stage = _build.WeightStage()
    assert torch.equal(stage(w, nt), got) and stage.launches == 0
    assert isinstance(_build.staged, _build.WeightStage)
