"""The forward stage on the shared main loop (``cindm_tpu_torch/ops/csrc/
conv_gn_mish.cuh`` on ``stage_ring.cuh``), checked on the CPU.

The stage runs persistent CTAs, at most one an SM, each walking the plan's
(row tile, N tile) pairs in a fixed order; a producer warp fills a ring of
stages of whole chunks (one TMA box of the tile's 192 rows, one bulk copy
of the stage's weight blocks) for three consumer warpgroups. Here the plan
(``_build.plan_stage``) is held to the rules that walk and ring need at
every shape the denoiser and the smoke's other paths launch, the N-tile
rule to its choices at batch 5,376, and a numpy emulation of the loop
(``torch_stage_emulation``) to the JAX package's ``fused_rtb`` and
``fused_conv1d_gn_mish`` and, bit for bit, to the earlier loop's order."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cindm_tpu.ops.fused_conv_gn import fused_conv1d_gn_mish as jax_cgm
from cindm_tpu.ops.fused_rtb import fused_rtb as jax_fused_rtb
from cindm_tpu_torch.ops import _build
from cindm_tpu_torch.tools import stage_ablation
from torch_stage_emulation import block_emulated, stage_emulated

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


def check_plan(B, T, C, O, proj):
    """The rules the persistent walk, the ring and the launch's own check
    need of one stage's plan."""
    G = 8
    plan = _build.plan_stage(B, T, C, O, G, proj=proj)
    nt, og = plan.n_tile, O // G
    # the walk (conv_gn_mish_stage: CTA q takes tiles t = q, q + ctas, ..,
    # tile t being row tile t / N tiles and N tile t % N tiles) covers every
    # (row tile, N tile) once, at most one CTA an SM
    walked = [divmod(t, plan.grid[1]) for q in range(plan.ctas) for t in range(q, plan.tiles, plan.ctas)]
    assert sorted(walked) == [(r, n) for r in range(plan.grid[0]) for n in range(plan.grid[1])]
    assert plan.ctas == min(plan.tiles, _build.H100_SMS)
    # shared memory: the C side's stage_smem_bytes restated from its parts
    ch, stages, ring = _build.stage_ring(nt)
    stage = -(-(-(-192 * 32 * ch // 1024) * 1024 + ch * 2 * K * (nt // 8) * 256) // 1024) * 1024
    assert ring == stages * stage
    gpt = min(O, nt) // og
    tile = 192 * (nt + 4) * 4
    if nt == 128 and not proj:  # deep: 4 slots under the tile
        assert 4 * stage >= tile
        region, stages = 4 * stage, 4
    else:  # the tile beside the ring
        region = ring + tile
    assert plan.smem_bytes == 1024 + region + 8 * plan.samples * gpt + 16 * stages + 8
    assert plan.smem_bytes <= _build.SMEM_MAX == 232448
    # every TMA box's row pitch (the stage's channels: the conv's, the
    # projection's) and every tensor's row pitch it reads (x, h, xres) are
    # whole 16-byte units, within the 128-byte swizzle's span
    pch = _build.PROJ_CHUNKS[nt]
    assert all(32 * c % 16 == 0 and 32 * c <= 128 for c in (ch, pch))
    assert all(4 * c % 16 == 0 for c in (C, O))
    # a projection stage (its box and pch blocks of one tap) fits a slot
    assert -(-192 * 32 * pch // 1024) * 1024 + pch * 2 * (nt // 8) * 256 <= stage
    # every bulk copy (a stage's weight blocks, of 5 taps or of the
    # projection's 1) and its source offset are whole 16-byte units
    nch = -(-C // 8)
    for taps, per in ((K, ch), (1, pch)):
        block = 2 * taps * (nt // 8) * 256
        for c in range(0, nch, per):
            assert (min(per, nch - c) * block) % 16 == 0 and (c * block) % 16 == 0
    assert plan.weight_bytes(C) % 16 == 0 and plan.weight_bytes(C, K=1) % 16 == 0
    return plan


def _plans():
    for C, O, T in RTB_SHAPES + [HEAD_SHAPE]:
        for B in BATCHES:
            yield C, O, T, B


@pytest.mark.parametrize("C,O,T,B", list(_plans()), ids=lambda v: str(v))
def test_stage_plan_walks_every_tile_once_within_the_card(C, O, T, B):
    plan = check_plan(B, T, C, O, proj=C != O)
    other = check_plan(B, T, C, O, proj=C == O)
    assert (other.n_tile, other.grid, other.ctas) == (plan.n_tile, plan.grid, plan.ctas)


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
        check_plan(B, T, C, O, proj=False)


def test_the_forward_profile_runs_the_smoke_s_design():
    """tools/forward_profile's design run is the smoke's flagship geometry."""
    from cindm_tpu_torch.tools import forward_profile

    assert forward_profile.DESIGN_ARGS == chip_smoke.DESIGN_ARGS
    assert (forward_profile.RECURRENCE, forward_profile.N_WINDOWS, forward_profile.N_PAIRS) == (
        chip_smoke.RECURRENCE, chip_smoke.N_WINDOWS, chip_smoke.N_PAIRS)


def test_n_tile_takes_the_fewer_waves_of_work_and_the_wide_tile_on_a_tie():
    def nt(C, O, T, B=5376):
        return _build.plan_stage(B, T, C, O, 8).n_tile
    # 168 tiles of 128 channels: 2 waves x 128 > 3 waves (336 tiles) x 64
    assert nt(512, 256, 3) == 64 and nt(256, 128, 6) == 64
    assert _build.plan_stage(5376, 3, 512, 256, 8).tiles == 336
    # a tie (336 tiles of 128, 3 waves, against 672 of 64, 6 waves): the wide tile
    assert nt(1024, 512, 3) == 128 and nt(512, 512, 3) == 128 and nt(64, 128, 12) == 128
    # one N tile of either width: the narrow one is less work
    assert nt(64, 64, 24) == 64
    # at the training batch every grid is one wave: the narrow tile
    assert nt(1024, 512, 3, B=512) == 64


def test_the_plan_mirrors_the_c_constants():
    """_build's ring and shared-memory mirror restate stage_ring.cuh's and
    conv_gn_mish.cuh's: chunks a stage, stages, and the bytes' terms."""
    assert "template <int NT, int Stages = (NT == 64 ? 3 : 2), int Ch = (NT == 64 ? 2 : 1), size_t SlotBytes = 0>" in STAGE_RING
    assert [_build.stage_ring(nt)[:2] for nt in (64, 128)] == [(2, 3), (1, 2)]
    body = re.search(r"stage_smem_bytes\(int nt, int samples, int groups_per_tile, bool deep\) \{(.*?)\n\}",
                     CONV_GN_MISH, re.S).group(1)
    assert "const int stages = deep ? kDeepStages" in body
    assert "deep ? (ring > tile_bytes(nt) ? ring : tile_bytes(nt)) : ring + tile_bytes(nt)" in body
    assert "1024 + region + 8 * size_t(samples) * groups_per_tile + 16 * stages + 8" in body
    assert f"constexpr int kDeepStages = {_build.DEEP_STAGES};" in CONV_GN_MISH
    assert "const bool deep = nt == 128 && !proj;" in CONV_GN_MISH
    assert "using ProjRing = StageRing<NT, ConvRing<NT, kDeep>::kStages, NT == 64 ? 4 : 2," in CONV_GN_MISH
    assert _build.PROJ_CHUNKS == {64: 4, 128: 2}
    assert "*ctas = tiles < sms ? tiles : sms;" in CONV_GN_MISH
    for gone in ("conv_gemm", "cp_async", "kXStages", "kXStride"):
        assert gone not in CONV_GN_MISH + STAGE_RING
    assert not hasattr(_build, "X_STAGES") and not hasattr(_build, "X_STRIDE")


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


# (C, O, T, B, N tile): T = 24, 6 and 3, with and without the projection,
# ragged last row tiles (8, 32 and 64 samples a tile), both N tiles (128:
# one chunk a stage, the projection's two-stage units), and the TPU
# kernel's own shapes under Pallas's interpreter (C, O multiples of 128)
BLOCK_CASES = [
    (16, 32, 24, 11, 64), (32, 32, 24, 8, 64), (16, 32, 6, 35, 64), (32, 32, 3, 70, 64),
    (64, 128, 3, 6, 128), (24, 64, 12, 17, 64), (128, 256, 24, 2, 128), (128, 128, 24, 2, 64),
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
