"""The forward stage's weight layout (``stage_weights`` in
``cindm_tpu_torch/ops/csrc/conv_gn_mish.cuh``, entry ``cindm_stage_weights``)
and the cache that runs it (``_build.WeightStage``), checked on the CPU.

One launch lays out up to three weight tensors (a block's w1, w2 and wres,
or the head's w), a thread block per (job, N tile, group of 8 chunks, tap):
it reads its slab of w along O in 16-byte pieces into a padded shared tile
and writes the 8 chunks' big and small planes of its tap, 16 bytes a
thread. A numpy emulation of that launch (the job list, the block -> job
lookup and its share, each thread's loads into the tile and its words of
the planes) is held bit for bit to ``stage_weights_reference`` at every
launch the denoiser makes at batches 512 and 5,376 and at odd shapes, with
every output word written exactly once. The cache's list entry
(``WeightStage.many``) is held to one stager call a kernel call, for the
weights that changed only."""

import re

import numpy as np
import pytest
import torch

from cindm_tpu_torch.ops import _build
from torch_port_helpers import tf32_split

K = 5
RTB_SHAPES = [
    (8, 64, 24), (64, 64, 24), (64, 128, 12), (128, 128, 12),
    (128, 256, 6), (256, 256, 6), (256, 512, 3), (512, 512, 3),
    (512, 512, 3), (512, 512, 3),
    (1024, 512, 3), (512, 256, 3), (512, 256, 6), (256, 128, 6),
    (256, 128, 12), (128, 64, 12),
]
HEAD_SHAPE = (64, 64, 24)
CONV_GN_MISH = (_build.CSRC / "conv_gn_mish.cuh").read_text()
STAGE_RING = (_build.CSRC / "stage_ring.cuh").read_text()
# the kernel's constants (stage_ring.cuh, conv_gn_mish.cuh), held to the source below
THREADS, COLS, PITCH, JOBS = 256, 64, 132, 3


def layout_blocks(K_, C, O, nt):
    """Thread blocks of one job: per N tile, group of 8 chunks and tap."""
    return -(-O // nt) * ((-(-C // 8) + 7) // 8) * K_


def layout_grid(shapes, nt):
    """Each job's first block (absent jobs: the first past the grid) and the grid."""
    block0, blocks = [], 0
    for i in range(JOBS):
        block0.append(blocks)
        if i < len(shapes):
            blocks += layout_blocks(*shapes[i], nt)
    return block0, blocks


def emulate_launch(ws, nt):
    """One launch of stage_weights<nt> on up to three w [K, C, O] (numpy
    float32): the planes it writes (uint32 words) and how often each word was
    written, thread by thread (vectorised over the blocks and threads)."""
    shapes = [w.shape for w in ws]
    block0, grid = layout_grid(shapes, nt)
    bx = np.arange(grid)
    job = np.where(bx < block0[1], 0, np.where(bx < block0[2], 1, 2))  # the block -> job lookup
    row4, plane = nt // 4, nt * 8
    quads = plane // 4
    outs, writes = [], []
    for j, (w, (K_, C, O)) in enumerate(zip(ws, shapes)):
        local = bx[job == j] - block0[j]
        nchunks = -(-C // 8)
        ngroups = (nchunks + 7) // 8
        tap, grp, ntile = local % K_, local // K_ % ngroups, local // (K_ * ngroups)
        o0, c0 = (ntile * nt)[:, None], (grp * COLS)[:, None]
        nb = len(local)
        # the loads: thread t's float4 i = t + k * THREADS of the slab, row
        # c = i / (nt / 4), columns 4 (i % (nt / 4)) .. + 3; zero past C or O
        tile = np.full((nb, COLS, PITCH), np.nan, np.float32)  # what no thread writes stays NaN
        i = np.arange(COLS * row4 // THREADS)[:, None] * THREADS + np.arange(THREADS)[None, :]
        c, o = (i // row4).reshape(1, -1), (4 * (i % row4)).reshape(1, -1)
        inside = (c0 + c < C) & (o0 + o < O)
        for q in range(4):
            v = w[tap[:, None], np.minimum(c0 + c, C - 1), np.minimum(o0 + o + q, O - 1)]
            tile[np.arange(nb)[:, None], c, o + q] = np.where(inside, v, np.float32(0))
        # the stores: uint4 e .. e + 3 of chunk ch's big plane, the same of its
        # small plane, for i < the block's chunks x nt * 2 (thread i % THREADS)
        nch = np.minimum(8, nchunks - grp * 8)[:, None]
        block = 2 * K_ * plane
        base = ((ntile * nchunks + grp * 8) * block + 2 * tap * plane)[:, None]
        i = np.arange(8 * quads)[None, :]
        live = np.broadcast_to(i < nch * quads, (nb, i.size))
        ch, e = i // quads, 4 * (i % quads)
        o = (e >> 6) * 8 + ((e & 31) >> 2)
        c = ch * 8 + ((e & 63) >> 5) * 4
        vals = np.stack([tile[np.arange(nb)[:, None], c + q, np.broadcast_to(o, c.shape)] for q in range(4)], -1)
        with np.errstate(invalid="ignore"):  # inf - inf in the split of an inf entry
            big, small = (h.view(np.uint32) for h in tf32_split(vals[live]))
        dst = np.broadcast_to(base + ch * block + e, live.shape)[live]
        out = np.full(_build.staged_weight_bytes(nt, C, O, K_) // 4, 0xDEADBEEF, np.uint32)
        at = np.concatenate([dst + q for q in range(4)] + [dst + plane + q for q in range(4)])
        out[at] = np.concatenate([big[:, q] for q in range(4)] + [small[:, q] for q in range(4)])
        outs.append(out)
        writes.append(np.bincount(at, minlength=out.size))
    return outs, writes


def weights(shapes, seed, specials=False):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if specials:
        for w in ws:
            w.reshape(-1)[rng.choice(w.size, 3, replace=False)] = [np.inf, -np.inf, np.nan]
    return ws


def check_launch(ws, nt):
    outs, writes = emulate_launch(ws, nt)
    for w, out, n in zip(ws, outs, writes):
        assert (n == 1).all()  # every word of the layout, once
        want = _build.stage_weights_reference(torch.from_numpy(w), nt).numpy().view(np.uint32)
        np.testing.assert_array_equal(out, want)


def denoiser_launches(B):
    """The layout launches of the denoiser's calls at batch B: per block w1,
    w2 (and wres) at the block's N tile, the head's w at its own."""
    out = []
    for C, O, T in RTB_SHAPES:
        nt = _build.plan_stage(B, T, C, O, 8).n_tile
        out.append(([(K, C, O), (K, O, O)] + ([(1, C, O)] if C != O else []), nt))
    C, O, T = HEAD_SHAPE
    out.append(([(K, C, O)], _build.plan_stage(B, T, C, O, 8).n_tile))
    return out


@pytest.mark.parametrize("B", [512, 5376])
@pytest.mark.parametrize("i", range(len(RTB_SHAPES) + 1))
def test_emulated_launch_lays_out_the_denoiser_s_weights_as_the_reference(B, i):
    shapes, nt = denoiser_launches(B)[i]
    check_launch(weights(shapes, seed=i + B), nt)


@pytest.mark.parametrize("nt", [64, 128])
@pytest.mark.parametrize("shapes", [
    [(K, 8, 64)], [(K, 12, 136)], [(K, 40, 8)], [(1, 40, 136)],
    # three jobs with ragged block counts: 1 x 1 x 5, 3 x 1 x 1, 3 x 2 x 5 at nt = 64
    [(K, 12, 64), (1, 40, 136), (K, 72, 136)],
    [(K, 136, 12), (K, 8, 200), (1, 520, 16)],
], ids=str)
def test_emulated_launch_at_odd_shapes_with_inf_and_nan(nt, shapes):
    check_launch(weights(shapes, seed=len(shapes) + nt, specials=True), nt)


def test_the_emulation_mirrors_the_kernel_s_source():
    """The launch's grid, the block -> job lookup and its share, the tile's
    pitch and the word mapping as stage_ring.cuh and conv_gn_mish.cuh write
    them, which the emulation restates."""
    assert "constexpr int kLayoutJobs = 3;" in STAGE_RING and _build.LAYOUT_JOBS == JOBS
    assert "constexpr int kLayoutThreads = 256;" in STAGE_RING
    assert "constexpr int kLayoutCols = 8 * kChunk;" in STAGE_RING
    assert "return (O + nt - 1) / nt * (((C + kChunk - 1) / kChunk + 7) / 8) * K;" in STAGE_RING
    assert "b.j = bx < j1.block0 ? j0 : bx < j2.block0 ? j1 : j2;" in STAGE_RING
    assert ("b.tap = local % b.j.K;\n  b.grp = local / b.j.K % ngroups;\n"
            "  b.ntile = local / (b.j.K * ngroups);") in STAGE_RING
    assert "constexpr int kLayoutPitch = 128 + 4;" in CONV_GN_MISH
    kernel = re.search(r"__global__ void __launch_bounds__\(kLayoutThreads\) stage_weights\(.*?\n\}",
                       CONV_GN_MISH, re.S).group(0)
    for line in ("const int i = threadIdx.x + k * kLayoutThreads, c = i / kRow4, o = 4 * (i % kRow4);",
                 "if (c0 + c < j.C && o0 + o < j.O) v = __ldg(",
                 "const int ch = i / kQuads, e = 4 * (i % kQuads);",
                 "const int o = (e >> 6) * 8 + ((e & 31) >> 2), c = ch * kChunk + ((e & 63) >> 5) * 4;",
                 "uint32_t* out = j.out + (lb.ntile * lb.nchunks + lb.grp * 8) * block + 2 * lb.tap * kPlane;",
                 "*reinterpret_cast<uint4*>(dst + kPlane) = small;"):
        assert line in kernel, line
    assert kernel.count("split_tf32(") == 4 and "size_t" not in kernel  # 32-bit indices
    # no grid-stride cap: the grid is the jobs' blocks
    launch = re.search(r"cudaError_t launch_stage_weights\(.*?\n\}", CONV_GN_MISH, re.S).group(0)
    assert "const int blocks = layout_grid(jobs, n);" in launch and "4096" not in launch
    # stage_weights_t takes its job from the same lookup
    backward = (_build.CSRC / "conv_backward.cuh").read_text()
    assert "const LayoutBlock lb = layout_block(j0, j1, j2);" in backward and "StageJobT" not in backward


def test_conflict_free_plane_reads():
    """Each of a warp's four tile reads in the write loop falls on 32
    distinct banks (tile rows PITCH floats apart), at either N tile."""
    for nt in (64, 128):
        quads = nt * 8 // 4
        for warp in range(8 * quads // 32):
            i = warp * 32 + np.arange(32)
            ch, e = i // quads, 4 * (i % quads)
            o = (e >> 6) * 8 + ((e & 31) >> 2)
            c = ch * 8 + ((e & 63) >> 5) * 4
            for q in range(4):
                assert len(set(((c + q) * PITCH + o) % 32)) == 32


def test_layout_args_pack_the_jobs():
    ws = [torch.zeros(K, 8, 16), torch.zeros(1, 40, 136)]
    outs = [torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)]
    w, out, dims, n = _build.layout_args([(ws[0], 64), (ws[1], 64)], outs)
    assert list(w) == [t.data_ptr() for t in ws] and list(out) == [t.data_ptr() for t in outs]
    assert list(dims) == [K, 8, 16, 64, 1, 40, 136, 64] and n == 2
    assert _build.SIGNATURES["cindm_stage_weights"] == _build.SIGNATURES["cindm_stage_weights_t"]


def test_the_cpu_stager_lays_out_a_list():
    ws = [torch.from_numpy(w) for w in weights([(K, 12, 72), (1, 12, 72)], seed=3)]
    stage = _build.WeightStage()
    got = stage.stage([(ws[0], 64), (ws[1], 128)])
    assert all(torch.equal(g, _build.stage_weights_reference(w, nt)) for g, w, nt in zip(got, ws, (64, 128)))
    assert stage.launches == 0 and stage.layouts == 0  # the CPU path counts no launch


class _Stager:
    """A stand-in for the layout launch: each call's jobs (shape, N tile),
    and w's values with the N tile appended."""

    def __init__(self):
        self.launches = []

    def __call__(self, jobs):
        self.launches.append([(tuple(w.shape), nt) for w, nt in jobs])
        return [torch.cat([w.detach().reshape(-1).clone(), torch.tensor([float(nt)])]) for w, nt in jobs]


def _block(seed, C=8, O=16):
    rng = np.random.default_rng(seed)
    p = lambda *s: torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
    return p(K, C, O), p(K, O, O), p(1, C, O)


def _holds(planes, w):
    return torch.equal(planes[:-1], w.detach().reshape(-1))


def test_a_block_s_stale_weights_go_in_one_stager_call():
    stage = _build.WeightStage(_Stager())
    w1, w2, wres = _block(0)
    got = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])
    assert stage.stager.launches == [[((K, 8, 16), 64), ((K, 16, 16), 64), ((1, 8, 16), 64)]]
    assert all(_holds(p, w) for p, w in zip(got, (w1, w2, wres)))
    again = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])  # fresh: nothing restaged
    assert len(stage.stager.launches) == 1 and all(a is b for a, b in zip(again, got))
    head = stage.many([(w2, 64)])  # another call that shares a weight takes it kept
    assert head[0] is got[1] and len(stage.stager.launches) == 1


def test_after_only_w1_changes_the_next_call_is_one_launch_of_one_job():
    stage = _build.WeightStage(_Stager())
    w1, w2, wres = _block(1)
    first = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])
    with torch.no_grad():
        torch._foreach_add_([w1], [torch.ones_like(w1)])
    got = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])
    assert stage.stager.launches[1:] == [[((K, 8, 16), 64)]]
    assert _holds(got[0], w1) and not _holds(first[0], w1)
    assert got[1] is first[1] and got[2] is first[2] and len(stage) == 3


def test_the_list_entry_keeps_planes_per_n_tile_and_keys_views_on_their_tensor():
    """A block at another N tile lays out all of its weights again, in one
    call, and keeps both; the projection comes as the view weight[0] of a
    [1, C, O] parameter, a new view every call: one entry, staged as K = 1,
    restaged once the parameter changes."""
    stage = _build.WeightStage(_Stager())
    w1, w2, wres = _block(2)
    p64 = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])
    p128 = stage.many([(w1, 128), (w2, 128), (wres[0], 128)])
    assert [len(x) for x in stage.stager.launches] == [3, 3] and len(stage) == 6
    assert stage.stager.launches[1][2] == ((1, 8, 16), 128) and p128[2][-1] == 128
    assert all(a is b for a, b in zip(stage.many([(w1, 64), (w2, 64), (wres[0], 64)]), p64))
    with torch.no_grad():
        wres.mul_(3.0)  # the view shares the parameter's version counter
    got = stage.many([(w1, 64), (w2, 64), (wres[0], 64)])
    assert stage.stager.launches[2] == [((1, 8, 16), 64)] and _holds(got[2], wres)
    stage.clear()
    assert len(stage) == 0
    stage.many([(w1, 64), (w2, 64)])
    assert len(stage.stager.launches[3]) == 2


def test_a_weight_asked_for_twice_in_one_call_is_laid_out_once():
    stage = _build.WeightStage(_Stager())
    w1, _, _ = _block(3, C=16)
    a, b = stage.many([(w1, 64), (w1, 64)])
    assert stage.stager.launches == [[((K, 16, 16), 64)]] and a is b


def test_a_call_s_weights_of_two_n_tiles_go_in_one_stager_call_each():
    """The attention kernel's wqkv (N tiles of 128) and wout (64) in one
    ``many`` call: a stager call for each N tile, in the order first asked,
    and both kept."""
    stage = _build.WeightStage(_Stager())
    rng = np.random.default_rng(5)
    wqkv, wout = (torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
                  for s in ((16, 384), (128, 16)))
    got = stage.many([(wqkv, 128), (wout, 64)])
    assert stage.stager.launches == [[((1, 16, 384), 128)], [((1, 128, 16), 64)]]
    assert _holds(got[0], wqkv) and _holds(got[1], wout) and float(got[0][-1]) == 128.0
    again = stage.many([(wqkv, 128), (wout, 64)])
    assert len(stage.stager.launches) == 2 and all(a is b for a, b in zip(again, got))
    with torch.no_grad():
        wout.add_(1.0)
    stage.many([(wqkv, 128), (wout, 64)])
    assert stage.stager.launches[2:] == [[((1, 128, 16), 64)]]
