"""The denoiser's resampling convolutions (``ops/resample.py``) and its batched
time projections on the CPU: the plain versions and the phase forms of
Upsample1d and Downsample1d against the JAX package's modules, an emulation
of the CUDA kernel's tiles (``csrc/resample.cu``) on the laid-out weights,
the route the models take to the kernel, its plan, and TemporalUnet1D with
the 16 blocks' projections in one product against the JAX model and the
per-block form."""

import re
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.models.blocks import Downsample1d as JaxDownsample1d
from cindm_tpu.models.blocks import Upsample1d as JaxUpsample1d
from cindm_tpu_torch.baselines import Unet1DForwardModel
from cindm_tpu_torch.models import TemporalUnet1D, params_from_flax
from cindm_tpu_torch.models import unet1d as unet1d_mod
from cindm_tpu_torch.models.blocks import Downsample1d, Upsample1d, mish
from cindm_tpu_torch.models.unet1d import _flip_convT
from cindm_tpu_torch.ops import (
    _build,
    downsample1d,
    downsample1d_differentiable,
    downsample1d_reference,
    fused_rtb,
    fused_rtb_reference,
    resample,
    upsample1d,
    upsample1d_differentiable,
    upsample1d_reference,
)
from cindm_tpu_torch.ops.resample import (
    downsample1d_phase,
    downsample_phase_weights,
    upsample1d_phase,
    upsample_phase_weights,
)
from cindm_tpu_torch.tools.resample_ablation import variant_plan

TOL = 1e-5
WIDTHS = [8, 16]
TIMES = [3, 6, 12, 24]
BATCHES = [2, 5]
# (C, T_in) of the flagship's three Upsample1d and three Downsample1d, in call order
FLAGSHIP_UP = [(256, 3), (128, 6), (64, 12)]
FLAGSHIP_DOWN = [(64, 24), (128, 12), (256, 6)]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU products: one thread each, or the tier-1 run's workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(B, T, C, seed):
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max()) / scale


def _jax_up(C, x, seed):
    """JAX Upsample1d's output and the port's (w [C, C, 4], b) through the
    weight mapping (``_flip_convT``)."""
    m = JaxUpsample1d(C)
    p = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    k, b = (np.asarray(p["params"]["ConvTranspose_0"][n]) for n in ("kernel", "bias"))
    b = b + 0.1 * np.random.default_rng(seed).standard_normal(C).astype(np.float32)
    p = {"params": {"ConvTranspose_0": {"kernel": k, "bias": b}}}
    return np.asarray(m.apply(p, x)), torch.from_numpy(_flip_convT(k)), torch.from_numpy(b)


def _jax_down(C, x, seed):
    """JAX Downsample1d's output and the port's (w [3, C, C], b), carried over as is."""
    m = JaxDownsample1d(C)
    p = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    k, b = (np.asarray(p["params"]["Conv1d_0"]["Conv_0"][n]) for n in ("kernel", "bias"))
    b = b + 0.1 * np.random.default_rng(seed).standard_normal(C).astype(np.float32)
    p = {"params": {"Conv1d_0": {"Conv_0": {"kernel": k, "bias": b}}}}
    return np.asarray(m.apply(p, x)), torch.from_numpy(np.array(k)), torch.from_numpy(b)


# -- the plain versions and the phase forms against the JAX package


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("T", TIMES)
@pytest.mark.parametrize("C", WIDTHS)
def test_upsample_plain_and_phase_forms_match_jax(C, T, B):
    x = _x(B, T, C, seed=C + T + B)
    want, w, b = _jax_up(C, x, seed=T)
    mod = Upsample1d(C, generator=torch.Generator().manual_seed(0))
    mod.load_state_dict({"weight": w, "bias": b})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = mod(xt)
        phase = upsample1d_phase(xt, *upsample_phase_weights(w), b)
    assert plain.shape == (B, 2 * T, C)
    _close(plain, want)
    _close(phase, want)
    _close(phase, plain)
    torch.testing.assert_close(plain, upsample1d_reference(xt, w, b), rtol=0, atol=0)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("T", TIMES + [5])
@pytest.mark.parametrize("C", WIDTHS)
def test_downsample_plain_and_phase_forms_match_jax(C, T, B):
    x = _x(B, T, C, seed=C + T + B)
    want, w, b = _jax_down(C, x, seed=T)
    mod = Downsample1d(C, generator=torch.Generator().manual_seed(0))
    mod.load_state_dict({"conv.weight": w, "conv.bias": b})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = mod(xt)
        phase = downsample1d_phase(xt, *downsample_phase_weights(w), b)
    assert plain.shape == (B, -(-T // 2), C)
    _close(plain, want)
    _close(phase, want)
    _close(phase, plain)
    torch.testing.assert_close(plain, downsample1d_reference(xt, w, b), rtol=0, atol=0)


def test_phase_weights_are_the_taps_by_phase():
    w = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)  # [C_in, C_out, K]
    even, odd = upsample_phase_weights(w)
    assert even.is_contiguous() and odd.is_contiguous() and even.shape == odd.shape == (2, 2, 3)
    for got, k in ((even[0], 3), (even[1], 1), (odd[0], 2), (odd[1], 0)):
        torch.testing.assert_close(got, w[:, :, k], rtol=0, atol=0)
    w = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 2)  # [K, C_in, C_out]
    hi, lo = downsample_phase_weights(w)
    assert hi.shape == (2, 2, 2) and lo.shape == (1, 2, 2)
    for got, k in ((hi[0], 0), (hi[1], 2), (lo[0], 1)):
        torch.testing.assert_close(got, w[k], rtol=0, atol=0)


# -- an emulation of the kernel's tiles on the laid-out weights


def _planes_to_weights(words, K, C, O, nt):
    """Inverse of ``stage_weights_reference``: the layout's big + small planes
    back to w [K, C, O] (exact: they sum to the fp32 value)."""
    nch, ntiles = -(-C // 8), -(-O // nt)
    planes = words.view(torch.float32).reshape(ntiles, nch, K, 2, nt // 8, 2, 8, 4)
    # [N tile, chunk, K, split, n8, K half, channel of 8, input of 4] -> [K, split, C, O]
    w = planes.permute(2, 3, 1, 5, 7, 0, 4, 6).reshape(K, 2, nch * 8, ntiles * nt)
    return (w[:, 0] + w[:, 1])[:, :C, :O]


def _tap_rows(rows, s0, ns, S, c0, c1, shift):
    """A of one tap on a tile's 192 rows (row s Tg + t of samples [s0, s0 +
    ns) of the GEMM's rows [B, Tg, W], channels [c0, c1)): each fragment
    row's own row shifted, zero outside its sample or past the tile's
    samples (ring_consume's masks; shift 0 is down's first part, which
    ring_consume_ss reads whole: the same rows)."""
    Tg = rows.shape[1]
    j = torch.arange(192)
    s, t = j // Tg, j % Tg
    ok = (s < ns) & (t + shift >= 0) & (t + shift < Tg)
    src = rows[(s0 + s.clamp(max=max(ns - 1, 0))), (t + shift).clamp(0, Tg - 1), c0:c1]
    return torch.where(ok[:, None], src, torch.zeros((), dtype=rows.dtype))


def emulate(x, w, b, up, sms=_build.H100_SMS, dtype=torch.float32, plan=None):
    """The kernel's decomposition (csrc/resample.cu) on ``plan`` (the
    kernel's own by default): per cluster item of the plan and row tile of
    it, each part of the item's ring stages of a chunk (a split item's parts
    summed in part order, part 0 first), per part of K (up: the even tiles'
    shifts -1, 0, the odd tiles' 0, +1; down: shift 0 over x2's first C,
    then -1, 0 over its last C) the taps' A rows as the consumers read them,
    times the weights as stage_weights lays them out for the N tile (decoded
    back), + the bias."""
    B, T, C = x.shape
    plan = plan or _build.plan_resample(B, T, C, up, sms)
    nt, S, Tg = plan.n_tile, plan.samples, plan.rows
    nch = nst = -(-C // 8)
    nh = -(-C // nt)
    wa, wb = (upsample_phase_weights if up else downsample_phase_weights)(w)
    wa, wb = (_planes_to_weights(_build.stage_weights_reference(v, nt), v.shape[0], C, C, nt).to(dtype)
              for v in (wa, wb))
    rows = (x if up else x.reshape(B, T // 2, 2 * C)).to(dtype)
    out = torch.zeros((B, Tg, 2 * C if up else C), dtype=dtype)

    def part_sums(s0, ns, n, k0, k1):
        half, n0 = (n // nh if up else 0), (n % nh) * nt
        cols = slice(n0, min(C, n0 + nt))
        if up:  # (weights, shifts, x2's channel offset, chunks)
            parts = [(wb, (0, 1), 0, k0, k1) if half else (wa, (-1, 0), 0, k0, k1)]
        else:
            parts = [(wb, (0,), 0, k0, min(k1, nst)), (wa, (-1, 0), C, max(k0 - nst, 0), k1 - nst)]
        acc = torch.zeros((192, cols.stop - n0), dtype=dtype)
        for wt, shifts, off, c0, c1 in parts:
            c0, c1 = min(c0, nch) * 8, min(max(c1, 0) * 8, C)
            for u, sh in enumerate(shifts):
                if c1 > c0:
                    acc += _tap_rows(rows, s0, ns, S, off + c0, off + c1, sh) @ wt[u][c0:c1, cols]
        return acc

    for item in range(plan.items):
        n = item % plan.n_tiles
        half, n0 = (n // nh if up else 0), (n % nh) * nt
        ncols = min(C, n0 + nt) - n0
        for r in range(plan.cluster):
            rt = item // plan.n_tiles * plan.cluster + r
            if rt >= plan.row_tiles:  # an odd last row tile's partner: nothing to store
                continue
            s0 = rt * S
            ns = min(S, B - s0)
            sums = [part_sums(s0, ns, n, k0, k1) for k0, k1 in plan.item_parts(item)]
            acc = sums[0]
            for p in sums[1:]:
                acc = acc + p
            out[s0:s0 + ns, :, half * C + n0:half * C + n0 + ncols] = (
                acc[:ns * Tg].reshape(ns, Tg, ncols) + b[n0:n0 + ncols].to(dtype))
    return out.reshape(B, 2 * T, C) if up else out


@pytest.mark.parametrize("C, T", FLAGSHIP_UP + [(12, 5), (40, 7), (16, 1), (8, 24), (16, 35)])
def test_emulated_upsample_matches_plain(C, T):
    rng = np.random.default_rng(C * T)
    w = torch.from_numpy(rng.uniform(-1, 1, (C, C, 4)).astype(np.float32)) / (2 * C) ** 0.5
    b = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))
    for B, sms in ((3, _build.H100_SMS), (2 * 192 // T + 1, _build.H100_SMS), (5 * 192 // T + 3, 8)):
        x = torch.from_numpy(_x(B, T, C, seed=B))  # one partial row tile; a pair and a ragged third; a split tail
        plan = variant_plan("splitall", B, T, C, True, sms)  # the tail split at items of 2 chunks or more
        _close(emulate(x, w, b, up=True, plan=plan), upsample1d_reference(x, w, b))


@pytest.mark.parametrize("C, T", FLAGSHIP_DOWN + [(12, 10), (40, 14), (16, 2), (8, 48), (16, 70)])
def test_emulated_downsample_matches_plain(C, T):
    rng = np.random.default_rng(C * T)
    w = torch.from_numpy(rng.uniform(-1, 1, (3, C, C)).astype(np.float32)) / (3 * C) ** 0.5
    b = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))
    for B, sms in ((3, _build.H100_SMS), (2 * 384 // T + 1, _build.H100_SMS), (5 * 384 // T + 3, 8)):
        x = torch.from_numpy(_x(B, T, C, seed=B))
        plan = variant_plan("splitall", B, T, C, False, sms)
        _close(emulate(x, w, b, up=False, plan=plan), downsample1d_reference(x, w, b))


@pytest.mark.parametrize("up", [True, False])
@pytest.mark.parametrize("C, T", [(40, 6), (64, 12), (24, 14)])
def test_split_items_sum_to_the_whole(up, C, T):
    """A split item's parts, summed in part order, give the item run whole
    (float64: no rounding between the two orders of one sum), on a small
    card's split tail (at two chunks an item or more: the ablation's
    ``splitall``; the kernel's own rule splits none at these widths)."""
    B = 5 * (192 // (T if up else T // 2)) + 3
    rng = np.random.default_rng(C + T)
    w = torch.from_numpy(rng.standard_normal((C, C, 4) if up else (3, C, C)))
    b = torch.from_numpy(rng.standard_normal(C))
    x = torch.from_numpy(rng.standard_normal((B, T, C)))
    plans = [variant_plan(v, B, T, C, up, 8) for v in ("splitall", "whole")]
    assert plans[0].tail > 0 and plans[0].max_parts > 1 and plans[1].tail == 0
    assert _build.plan_resample(B, T, C, up, 8).tail == 0
    split, whole = (emulate(x, w, b, up, dtype=torch.float64, plan=p) for p in plans)
    torch.testing.assert_close(split, whole, rtol=1e-12, atol=1e-12)


# -- the plan, which the C source mirrors


@pytest.mark.parametrize("B", [5376, 5000, 512])
def test_plan_at_the_flagship_shapes(B):
    for (C, T), up in [(s, True) for s in FLAGSHIP_UP] + [(s, False) for s in FLAGSHIP_DOWN]:
        p = _build.plan_resample(B, T, C, up)
        assert p.rows == (T if up else T // 2) and p.samples * p.rows == 192
        assert p.row_tiles == -(-B // p.samples) and p.cluster == 2
        assert p.n_tiles == (2 if up else 1) * -(-C // p.n_tile)
        assert p.items == -(-p.row_tiles // 2) * p.n_tiles
        assert p.stages == C // 8 * (1 if up else 2)  # a chunk of 8 channels a ring stage
        # where full waves run at N tile 128 and the last wave is split, the N tile that pads C
        # less; else the fewer waves of items times the tile's width; 128 on a tie
        items = lambda nt: -(-p.row_tiles // 2) * (2 if up else 1) * -(-C // nt)
        width = ((lambda nt: -(-C // nt) * nt) if p.stages >= _build.RES_SPLIT_MIN_CHUNKS and items(128) >= 66
                 else (lambda nt: -(-items(nt) // 66) * nt))
        assert width(p.n_tile) == min(width(128), width(64)) and (p.n_tile == 128 or width(64) < width(128))
        assert p.smem_bytes <= _build.SMEM_MAX
        # the split tail: the partial wave's items, or every item of a launch of fewer than 66,
        # where an item has 32 chunks or more
        assert p.tail == (p.items % 66 if p.stages >= _build.RES_SPLIT_MIN_CHUNKS else 0)
        assert p.ctas == 2 * min(66, max(p.items - p.tail, p.tail_clusters))
    assert [_build.plan_resample(5376, T, C, True).n_tile for C, T in FLAGSHIP_UP] == [128, 128, 64]
    assert [_build.plan_resample(5376, T, C, False).n_tile for C, T in FLAGSHIP_DOWN] == [64, 128, 128]
    assert _build.plan_resample(1, 3, 64, True).cluster == 1


# (B, kind, C, T in) -> (N tile, items, split items, ranges, most parts of an item) on the H100's 132 SMs
FLAGSHIP_SPLITS = {
    (5376, "down", 64, 24): (64, 168, 0, 0, 1), (5376, "down", 128, 12): (128, 84, 18, 66, 5),
    (5376, "down", 256, 6): (128, 84, 18, 66, 5), (5376, "up", 256, 3): (128, 168, 36, 66, 3),
    (5376, "up", 128, 6): (128, 168, 0, 0, 1), (5376, "up", 64, 12): (64, 336, 0, 0, 1),
    (5000, "down", 128, 12): (128, 79, 13, 66, 6), (5000, "up", 256, 3): (128, 160, 28, 66, 4),
    (512, "down", 128, 12): (64, 16, 16, 66, 5), (512, "up", 256, 3): (64, 32, 32, 66, 3),
    (512, "up", 64, 12): (64, 32, 0, 0, 1), (512, "up", 128, 6): (64, 32, 0, 0, 1),
    (5000, "up", 128, 6): (64, 316, 0, 0, 1),
}


@pytest.mark.parametrize("key", list(FLAGSHIP_SPLITS), ids=str)
def test_plan_split_walks_every_stage_once(key):
    """The plan's N tile and split tail at 5,376, 5,000 and 512, and its walk:
    every ring stage of every item run once, by parts in part order, the
    busiest cluster within a stage of the mean where the last wave is split
    (else within an item)."""
    B, kind, C, T = key
    p = _build.plan_resample(B, T, C, kind == "up")
    assert (p.n_tile, p.items, p.tail, p.tail_clusters, p.max_parts) == FLAGSHIP_SPLITS[key]
    seen, work = {}, []
    for q in range(p.ctas // p.cluster):
        parts = p.walk(q * p.cluster)
        work.append(sum(k1 - k0 for *_, k0, k1, _, _ in parts))
        for rt, n, k0, k1, part, nparts in parts:
            item = rt // p.cluster * p.n_tiles + n
            assert p.item_parts(item)[part] == (k0, k1) and len(p.item_parts(item)) == nparts
            seen.setdefault(item, []).append((k0, k1))
    assert sorted(seen) == list(range(p.items))
    for item, ranges in seen.items():
        assert sorted(ranges) == p.item_parts(item)
        assert [k for k0, k1 in sorted(ranges) for k in range(k0, k1)] == list(range(p.stages))
    assert max(work) - sum(work) / len(work) <= (1 if p.tail else p.stages)


@pytest.mark.parametrize("C, T, up, why", [
    (62, 6, True, "multiple of 4"), (64, 7, False, "even T"), (64, 193, True, "rows a sample"),
    (64, 386, False, "rows a sample"), (0, 6, True, "multiple of 4"),
])
def test_plan_refuses_what_the_kernel_does_not_take(C, T, up, why):
    with pytest.raises(ValueError, match=why):
        _build.plan_resample(4, T, C, up)


def test_c_source_mirrors_the_plan():
    src = (Path(_build.CSRC) / "resample.cu").read_text()
    assert f"constexpr int kResTaps = {_build.RES_TAPS};" in src
    assert f"constexpr int kResSplitMinChunks = {_build.RES_SPLIT_MIN_CHUNKS};" in src
    assert "a.cs = row_tiles > 1 ? 2 : 1;" in src and "a.samples = kTileRows / a.T;" in src
    # the ring's slot: the box's two planes and the chunk's weight blocks; as many slots as fit
    assert "return align1024(2 * align1024(size_t(kTileRows) * 4 * kChunk) + weight_block_bytes(nt, kResTaps));" in src
    assert "return static_cast<int>((kSmemMax - 1024 - 16) / (resample_slot_bytes(nt) + 24));" in src
    assert "return 1024 + size_t(resample_stages(nt)) * (resample_slot_bytes(nt) + 24) + 16;" in src
    assert "using ResRing = StageRing<NT, resample_stages(NT), 1, resample_slot_bytes(NT), true>;" in src
    # the split and the CTAs: the stage's (walk_plan, stage_split, walk_part in stage_ring.cuh), one
    # chunk a ring stage, split where an item has kResSplitMinChunks or more
    assert "a.nst = (C + kChunk - 1) / kChunk;" in src and "a.stages = up ? a.nst : 2 * a.nst;" in src
    assert ("CINDM_TRY(walk_plan(a.items, a.stages, a.cs, s.num_sms, a.stages >= kResSplitMinChunks, &a.split, "
            "&ctas));") in src
    assert "walk_part(a.items, a.stages, a.split, a.cs, true, n, p)" in src
    for gone in ("res_split", "res_part", "kResChunks", "kResStreaming", "kResSplitParts", "range_of("):
        assert gone not in src, gone
    assert src.count("__stcs(") == 1 and "*dst = o" not in src  # one store path: the streaming hint
    # row-major tiles read the forward's ring with weight blocks of their window's taps
    assert "ring_consume<R, 3, kResTaps, Split::kPre, true, true>" in src and "ring_consume_ss<R, 1>" in src
    ring = (Path(_build.CSRC) / "stage_ring.cuh").read_text()
    assert "weight_block_bytes(NT, kRel ? KW : K)" in ring and "kRel ? k - tr.klo : k" in ring
    assert _build.SIGNATURES["cindm_resample"] == [_build._P] * 7
    names = re.search(r"struct ResampleLaunch \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:,|;)", re.sub(r"//[^\n]*", "", names))
    assert fields == [f for f, _ in _build.ResampleLaunch._fields_]
    for nt in (64, 128):
        assert _build.resample_smem_bytes(nt) <= _build.SMEM_MAX
    assert [_build.resample_ring(nt) for nt in (64, 128)] == [(11, 20480), (8, 28672)]  # PR 23's ring


def test_plan_weight_bytes_count_the_taps():
    p = _build.plan_resample(5376, 3, 256, True)
    even, odd = upsample_phase_weights(torch.zeros(256, 256, 4))
    assert p.weight_bytes(256) == sum(_build.staged_weight_bytes(p.n_tile, 256, 256, K=w.shape[0])
                                      for w in (even, odd))
    p = _build.plan_resample(5376, 6, 256, False)
    hi, lo = downsample_phase_weights(torch.zeros(3, 256, 256))
    assert p.weight_bytes(256) == sum(_build.staged_weight_bytes(p.n_tile, 256, 256, K=w.shape[0])
                                      for w in (hi, lo))


ABLATION = ["base", "nomma", "nosplit", "noepi", "whole", "splitall", "trim", "trimnoepi", "nostream", "nt64"]


@pytest.mark.parametrize("variant", ABLATION)
def test_ablation_variants_patch_the_kernel_once(variant):
    """``tools/resample_ablation``'s variants each find their places in the
    kernel's sources, and change them unless the variant is the kernel
    itself or differs by its plan alone; each variant's plan is one its
    patched C side takes: the kernel's own but for the split (none, or at
    two chunks an item or more) and the N tile of ``nt64``."""
    from cindm_tpu_torch.tools.resample_ablation import VARIANTS, patched

    src = {f: (Path(_build.CSRC) / f).read_text() for f in ("resample.cu", "stage_ring.cuh")}
    assert list(VARIANTS) == ABLATION
    assert (patched(variant, _build.CSRC, VARIANTS) == src) == (variant in ("base", "nt64"))
    for kind, C, T in [("down", 64, 24), ("up", 256, 3), ("up", 128, 6)]:
        own = _build.plan_resample(5376, T, C, kind == "up")
        p = variant_plan(variant, 5376, T, C, kind == "up", _build.H100_SMS)
        split_min = 2 if variant == "splitall" else _build.RES_SPLIT_MIN_CHUNKS
        split = variant not in ("whole", "trim", "trimnoepi") and p.stages >= split_min
        assert p.smem_bytes <= _build.SMEM_MAX and (p.tail > 0) == split
        assert p.n_tile == (64 if variant == "nt64" else own.n_tile)
        assert p.ctas == p.cluster * min(66, max(p.items - p.tail, p.tail_clusters))
        if variant in ("base", "nomma", "nosplit", "noepi", "nostream"):
            assert p == own


# -- the phase weights kept per weight version


def test_derived_weights_are_kept_per_version_and_dropped_by_clear():
    stage = _build.WeightStage()
    w = torch.randn(8, 8, 4)
    first = stage.derived(w, upsample_phase_weights)
    assert stage.derived(w, upsample_phase_weights) is first and len(stage) == 0
    assert stage.derived(w, downsample_phase_weights) is not first  # another rearrangement of w
    with torch.no_grad():
        w.add_(1.0)
    again = stage.derived(w, upsample_phase_weights)
    assert again is not first
    torch.testing.assert_close(again[0], upsample_phase_weights(w)[0], rtol=0, atol=0)
    g = stage.generation
    stage.clear()
    assert stage.generation == g + 1 and stage.derived(w, upsample_phase_weights) is not again


def test_clear_drops_derived_weights_that_hold_layouts():
    """A derived entry that keeps its tensors' own layouts (as the resampling
    wrapper's does): clearing frees those tensors, whose entries go too."""
    stage = _build.WeightStage()
    laid_out = lambda w: (parts := upsample_phase_weights(w), stage.many([(t, 64) for t in parts]))
    ws = [torch.randn(8, 8, 4) for _ in range(3)]
    parts = [weakref.ref(stage.derived(w, laid_out)[0][0]) for w in ws]
    assert len(stage) == 6 and all(p() is not None for p in parts)
    stage.clear()
    assert len(stage) == 0 and all(p() is None for p in parts)
    again = stage.derived(ws[1], laid_out)
    assert len(stage) == 2
    torch.testing.assert_close(again[1][0], _build.stage_weights_reference(again[0][0], 64), rtol=0, atol=0)


# -- the wrappers and the route


def test_wrappers_run_plain_on_the_cpu_and_refuse_a_gradient():
    C, T = 16, 6
    w_up, w_down = torch.randn(C, C, 4), torch.randn(3, C, C)
    b, x = torch.randn(C), torch.from_numpy(_x(3, T, C, seed=1))
    n_up, n_down = upsample1d.launches, downsample1d.launches
    torch.testing.assert_close(upsample1d(x, w_up, b), upsample1d_reference(x, w_up, b), rtol=0, atol=0)
    torch.testing.assert_close(downsample1d(x, w_down, b), downsample1d_reference(x, w_down, b),
                               rtol=0, atol=0)
    assert (upsample1d.launches, downsample1d.launches) == (n_up, n_down)
    with pytest.raises(RuntimeError, match="upsample1d_differentiable"):
        upsample1d(x.clone().requires_grad_(True), w_up, b)
    with pytest.raises(RuntimeError, match="downsample1d_differentiable"):
        downsample1d(x, w_down.requires_grad_(True), b)
    with pytest.raises(TypeError, match="float32"):
        upsample1d(x.double(), w_up, b)
    with pytest.raises(ValueError, match="shape"):
        downsample1d(x, torch.randn(3, C, C + 4), b)


class _Launcher:
    """A stand-in for a wrapper: counts the calls and returns the plain version."""

    def __init__(self, plain):
        self.plain, self.calls = plain, []

    def __call__(self, x, w, b):
        self.calls.append(tuple(x.shape))
        return self.plain(x, w, b)


@pytest.mark.parametrize("model", ["unet", "forward_model"])
def test_route_takes_the_kernels_only_without_a_gradient(monkeypatch, model):
    up, down = _Launcher(upsample1d_reference), _Launcher(downsample1d_reference)
    monkeypatch.setattr(resample, "upsample1d", up)
    monkeypatch.setattr(resample, "downsample1d", down)
    x = torch.from_numpy(_x(3, 24, 8, seed=0))
    if model == "unet":
        m = TemporalUnet1D(24, 8, dim=16)
        t = torch.tensor([1, 50, 900])
        run = lambda use_kernels: m(x, t, use_kernels)
    else:
        m = Unet1DForwardModel(24, 8, dim=16)
        run = lambda use_kernels: m(x[:, :1], x, use_kernels)
    with torch.no_grad():
        got, want = run(True), run(False)
    assert [(T, C) for _, T, C in down.calls] == [(24, 16), (12, 32), (6, 64)]
    assert [(T, C) for _, T, C in up.calls] == [(3, 64), (6, 32), (12, 16)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = (upsample1d_differentiable.autograd_calls, downsample1d_differentiable.autograd_calls)
    loss = run(True).square().mean()
    assert (len(up.calls), len(down.calls)) == (3, 3)  # a gradient is wanted: the plain path, no launch
    grads = torch.autograd.grad(loss, [u.weight for u in m.ups] + [d.conv.weight for d in m.downs])
    assert all(bool(g.abs().sum() > 0) for g in grads)
    # counted on CUDA tensors only
    assert (upsample1d_differentiable.autograd_calls, downsample1d_differentiable.autograd_calls) == before


# -- the 16 blocks' time projections in one product


def _random_flax_params(model, seed):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 8)), jnp.zeros(1, jnp.int32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            bound = float(np.prod(s.shape[:-1])) ** -0.5
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if name in ("scale", "g"):
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def dim8():
    """A dim-8 Flax TemporalUnet1D (horizon 24) with random parameters, and the port loaded from it."""
    jm = JaxUnet(horizon=24, transition_dim=8, dim=8)
    params = _random_flax_params(jm, seed=3)
    tm = TemporalUnet1D(24, 8, dim=8)
    tm.load_state_dict(params_from_flax(params, tm))
    return jax.jit(jm.apply), params, tm


def _per_block(monkeypatch):
    """Each block projecting its own Dense(mish(t)), as before the batched form."""
    monkeypatch.setattr(unet1d_mod.TimeProjections, "forward",
                        lambda self, t, denses: [d(mish(t)) for d in denses])


@pytest.mark.parametrize("t", [0, 7, 999])
def test_batched_projections_match_jax(dim8, t):
    apply, params, tm = dim8
    x = _x(5, 24, 8, seed=t)
    tt = np.array([t, 1, 500, 999, 3][:5], np.int32)
    want = np.asarray(apply(params, x, tt))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batched_projections_are_views_of_one_product(dim8):
    _, _, tm = dim8
    t = torch.randn(4, 8)
    with torch.no_grad():
        tembs = tm.time_proj(t, [r.time for r in tm.rtbs])
    assert len(tembs) == 16 and len({e.untyped_storage().data_ptr() for e in tembs}) == 1
    total = sum(r.time.weight.shape[1] for r in tm.rtbs)
    assert all(e.stride() == (total, 1) for e in tembs)
    for e, r in zip(tembs, tm.rtbs):
        _close(e, r.time(mish(t)).detach())


def test_batched_projections_gradients_match_the_per_block_form(dim8, monkeypatch):
    _, _, tm = dim8
    x = torch.from_numpy(_x(3, 24, 8, seed=11))
    t = torch.tensor([4, 300, 950])
    params = list(tm.parameters())

    def grads():
        loss = tm(x, t).square().mean()
        return [g.detach() for g in torch.autograd.grad(loss, params)]

    batched = grads()
    with monkeypatch.context() as mp:
        _per_block(mp)
        per_block = grads()
    # each within 1e-4 of itself, or 1e-6 of the model's largest entry: the
    # convs' biases before a GroupNorm have gradients of float32's noise alone
    gmax = max(float(b.abs().max()) for b in per_block)
    for (name, _), a, b in zip(tm.named_parameters(), batched, per_block):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * gmax, msg=name)


def test_kept_projections_follow_the_weights(dim8):
    _, _, tm = dim8
    t = torch.randn(2, 8)
    dense = tm.rtbs[5].time
    with torch.no_grad():
        first = tm.time_proj(t, [r.time for r in tm.rtbs])[5].clone()
        dense.bias.add_(1.0)  # an in-place write: a new version
        moved = tm.time_proj(t, [r.time for r in tm.rtbs])[5].clone()
        torch.testing.assert_close(moved, first + 1.0)
        dense.bias.data.sub_(1.0)  # through .data: no new version ...
        _build.staged.clear()  # ... which clear() marks (as parallel.mesh.replicate calls it)
        back = tm.time_proj(t, [r.time for r in tm.rtbs])[5]
    torch.testing.assert_close(back, first)


def test_fused_rtb_takes_a_row_strided_temb():
    rng = np.random.default_rng(2)
    B, T, C, O = 3, 12, 8, 16
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    wide = f(B, 3 * O)
    temb = wide[:, O:2 * O]
    assert not temb.is_contiguous()
    args = [f(B, T, C), temb, f(5, C, O) / 6, f(O), 1 + 0.1 * f(O), 0.1 * f(O), f(5, O, O) / 9, f(O),
            1 + 0.1 * f(O), 0.1 * f(O), f(C, O) / 3, f(O)]
    want = fused_rtb_reference(*args[:1], temb.contiguous(), *args[2:])
    torch.testing.assert_close(fused_rtb(*args), want, rtol=0, atol=0)
    assert _build.check_rows("fused_rtb", torch.device("cpu"), "temb", temb, (B, O)) == 3 * O
    with pytest.raises(ValueError, match="contiguous rows"):
        _build.check_rows("fused_rtb", torch.device("cpu"), "temb", wide[:, ::3][:, :O], (B, O))


def test_forward_profile_attributes_the_projections():
    from cindm_tpu_torch.tools.forward_profile import forward_ops

    m = TemporalUnet1D(24, 8, dim=16).eval()
    rec = forward_ops(torch, torch.device("cpu"), m, batch=2)
    proj = rec["modules"]["rtb_time_projection"]
    assert proj["launches"] > 0 and "aten::addmm" in proj["ops"] and "aten::mish" in proj["ops"]
    assert rec["groups"]["rtb_time_projection"]["modules"] == 16
    assert not any(re.search("addmm|mish", op) for k, v in rec["modules"].items() if k.startswith("rtb.")
                   for op in v["ops"])


def test_projection_launches_counts_both_forms():
    """``tools/forward_profile.projection_launches`` on the CPU (aten ops):
    the batched projections run fewer ops than the per-block form, without a
    gradient and under autograd."""
    from cindm_tpu_torch.tools.forward_profile import projection_launches

    m = TemporalUnet1D(24, 8, dim=8).eval()
    rec = projection_launches(torch, torch.device("cpu"), m, batch=3)
    for mode in ("sampling", "training"):
        assert 0 < rec["batched"][mode] < rec["per_block"][mode], (mode, rec)
