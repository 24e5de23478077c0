"""The denoiser's linear attention with its pre-norm and residual
(``ops/linear_attention.py``) on the CPU: its plain version against the JAX
package's ``PreNormResidual(C, LinearAttentionTemporal(C))``, a numpy
emulation of the CUDA kernel's decomposition (``csrc/linear_attention.cu``)
against the plain version, the route that the models take to the kernel,
and the kernel's plan."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.models.blocks import LinearAttentionTemporal as JaxAttention
from cindm_tpu.models.blocks import PreNormResidual as JaxPreNorm
from cindm_tpu_torch.baselines import Unet1DForwardModel
from cindm_tpu_torch.models import TemporalUnet1D
from cindm_tpu_torch.ops import (
    _build,
    linear_attention,
    prenorm_linear_attention,
    prenorm_linear_attention_differentiable,
    prenorm_linear_attention_reference,
)

# (C, T) of the flagship denoiser's 8 attention blocks, in call order
FLAGSHIP = [(64, 24), (128, 12), (256, 6), (512, 3), (512, 3), (256, 3), (128, 6), (64, 12)]
# the horizon-70 direct model's blocks: one sample of 70 a tile, three of 35
LONG = [(64, 70), (128, 35), (512, 35)]
HIDDEN = 128
EPS = 1e-5
SCALE = np.float32(32 ** -0.5)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU products: one thread each, or the tier-1 run's workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(C, seed):
    rng = np.random.default_rng(seed)
    return dict(g=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                wqkv=rng.uniform(-C ** -0.5, C ** -0.5, (C, 3 * HIDDEN)).astype(np.float32),
                wout=rng.uniform(-HIDDEN ** -0.5, HIDDEN ** -0.5, (HIDDEN, C)).astype(np.float32),
                bout=(0.1 * rng.standard_normal(C)).astype(np.float32))


def _x(B, T, C, seed):
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


def _plain(x, p):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return prenorm_linear_attention_reference(torch.from_numpy(x), t["g"], t["wqkv"], t["wout"],
                                              t["bout"]).numpy()


def _close(got, want, tol=1e-5):
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("C,T", FLAGSHIP, ids=[f"blk{i}-C{c}-T{t}" for i, (c, t) in enumerate(FLAGSHIP)])
def test_plain_version_matches_the_jax_block(C, T):
    """The plain version against PreNormResidual(C, LinearAttentionTemporal(C))
    of the JAX package on the same parameters, non-unit gain, batch 3."""
    p, x = _params(C, seed=C + T), _x(3, T, C, seed=T)
    block = JaxPreNorm(C, JaxAttention(C))
    params = {"ChannelLayerNorm_0": {"g": p["g"]},
              "fn": {"Dense_0": {"Dense_0": {"kernel": p["wqkv"]}},
                     "Dense_1": {"Dense_0": {"kernel": p["wout"], "bias": p["bout"]}}}}
    tree = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.zeros((1, T, C)))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == jax.tree_util.tree_map(np.shape, params)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    _close(_plain(x, p), want)


# -- a numpy emulation of the kernel, tile by tile


def _rna(a):
    """tf32 with round-to-nearest, ties away (split_tf32's rounding)."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _split(a):
    """split_tf32: big = tf32(a), small = tf32(a - big), both rounded."""
    big = _rna(a)
    return big, _rna((a - big).astype(np.float32))


def _planes(w, nt):
    """The tf32 big and small planes of w [K, N] read back from
    ``stage_weights_reference``'s layout for N tiles of nt (K = 1): per
    N tile and chunk of 8 inputs a block of the big plane, then the small,
    word q of n8 block j being channel j * 8 + (q % 32) // 4 of input
    q // 32 * 4 + q % 4."""
    K, N = w.shape
    words = _build.stage_weights_reference(torch.from_numpy(w), nt).numpy().view(np.float32)
    blocks = words.reshape(-(-N // nt), K // 8, 2, nt // 8, 2, 8, 4)  # tile, chunk, plane, n8, K half, n, k
    planes = blocks.transpose(2, 1, 4, 6, 0, 3, 5).reshape(2, K, -(-N // nt) * nt)
    return planes[0, :, :N], planes[1, :, :N]


def _tf3(a_big, a_small, w_big, w_small):
    """A product as the kernel issues it: per k8 chunk small*big, big*small,
    big*big into one fp32 accumulator."""
    acc = np.zeros(a_big.shape[:-1] + (w_big.shape[1],), np.float32)
    for c in range(0, w_big.shape[0], 8):
        k = slice(c, c + 8)
        acc += np.matmul(a_small[..., k], w_big[k], dtype=np.float32)
        acc += np.matmul(a_big[..., k], w_small[k], dtype=np.float32)
        acc += np.matmul(a_big[..., k], w_big[k], dtype=np.float32)
    return acc


def emulate(x, p, eps=EPS):
    """The kernel's decomposition: row tiles of ATTN_ROWS rows holding
    ATTN_ROWS // T whole samples (the rest padding; samples past the batch
    zero), each row's LayerNorm statistics (the mean, then the biased
    variance), xn split once into tf32 planes, the q | k | v product on the
    weights' laid-out planes chunk by chunk (q scaled as it is stored),
    then per sample and head e = exp(k - max) over T, the context e^T v
    times 1 / sum(e) and q context into the hidden tile, which is split
    once for the out product; bias and residual in the epilogue; only the
    rows of real samples kept."""
    B, T, C = x.shape
    M = _build.ATTN_ROWS
    S = M // T
    tiles = -(-B // S)
    xs = np.zeros((tiles, M, C), np.float32)
    xs[:, :S * T] = np.concatenate([x, np.zeros((tiles * S - B, T, C), np.float32)]).reshape(tiles, S * T, C)
    mean = xs.sum(-1, keepdims=True, dtype=np.float32) / np.float32(C)
    var = np.square(xs - mean).sum(-1, keepdims=True, dtype=np.float32) / np.float32(C)
    xn = (xs - mean) * (np.float32(1) / np.sqrt(var + np.float32(eps))) * p["g"]
    qkv = _tf3(*_split(xn), *_planes(p["wqkv"], _build.ATTN_QKV_NT))[:, :S * T].reshape(tiles, S, T, 3, 4, 32)
    hid = np.zeros((tiles, M, HIDDEN), np.float32)
    for h in range(4):
        q, k, v = qkv[..., 0, h, :] * SCALE, qkv[..., 1, h, :], qkv[..., 2, h, :]
        e = np.exp(k - k.max(axis=2, keepdims=True))  # k's softmax: e / z, z applied to the context
        rz = np.float32(1) / e.sum(axis=2, dtype=np.float32)  # [tiles, S, 32]
        context = np.matmul(np.swapaxes(e, -1, -2), v, dtype=np.float32) * rz[..., :, None]
        hid[:, :S * T, h * 32:(h + 1) * 32] = np.matmul(q, context, dtype=np.float32).reshape(tiles, S * T, 32)
    out = (_tf3(*_split(hid), *_planes(p["wout"], _build.ATTN_OUT_NT)) + p["bout"]) + xs
    return out[:, :S * T].reshape(tiles * S, T, C)[:B]


@pytest.mark.parametrize("C", [64, 512])
def test_weight_planes_are_split_tf32(C):
    """The planes the kernel reads, from stage_weights_reference's layout of
    wqkv [C, 384] and wout [128, C], are split_tf32's of each weight."""
    p = _params(C, seed=C)
    for w, nt in ((p["wqkv"], _build.ATTN_QKV_NT), (p["wout"], _build.ATTN_OUT_NT)):
        big, small = _planes(w, nt)
        want_big, want_small = _split(w)
        assert np.array_equal(big, want_big) and np.array_equal(small, want_small)
        assert np.abs((big + small) - w).max() <= 2.0 ** -21 * np.abs(w).max()


def _batches(T):
    """1, a batch that ends a tile mid-way, and one whose last tile holds
    one sample."""
    S = _build.ATTN_ROWS // T
    return dict.fromkeys((1, S + max(1, S // 2) if S > 1 else 2, S + 1))


@pytest.mark.parametrize("C,T", FLAGSHIP + LONG,
                         ids=[f"C{c}-T{t}" + ("-mid" if i == 4 else "") for i, (c, t) in enumerate(FLAGSHIP + LONG)])
def test_emulated_kernel_matches_plain(C, T):
    """Within 1e-5 of the plain version's largest entry at each of _batches."""
    p = _params(C, seed=3 * C + T)
    for B in _batches(T):
        x = _x(B, T, C, seed=B + T)
        _close(emulate(x, p), _plain(x, p))


# -- the route: kernel without a gradient, plain under autograd


class _Launcher:
    """A stand-in for the wrapper: counts the calls and returns the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, g, wqkv, wout, bout, heads, dim_head, eps):
        self.calls.append(tuple(x.shape))
        return prenorm_linear_attention_reference(x, g, wqkv, wout, bout, heads, dim_head, eps)


@pytest.mark.parametrize("model", ["unet", "forward_model"])
def test_route_takes_the_kernel_only_without_a_gradient(monkeypatch, model):
    launcher = _Launcher()
    monkeypatch.setattr(linear_attention, "prenorm_linear_attention", launcher)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 24, 8)).astype(np.float32))
    if model == "unet":
        m = TemporalUnet1D(24, 8, dim=16)
        t = torch.tensor([1, 50, 900])
        run = lambda use_kernels: m(x, t, use_kernels)
    else:
        m = Unet1DForwardModel(24, 8, dim=16, attention=True)
        run = lambda use_kernels: m(x[:, :1], x, use_kernels)
    with torch.no_grad():
        got, want = run(True), run(False)
    assert [(T, C) for _, T, C in launcher.calls] == [(24, 16), (12, 32), (6, 64), (3, 128), (3, 128),
                                                      (3, 64), (6, 32), (12, 16)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = prenorm_linear_attention_differentiable.autograd_calls
    loss = run(True).square().mean()
    assert len(launcher.calls) == 8  # a gradient is wanted: the plain path, no launch
    grads = torch.autograd.grad(loss, [a.fn.qkv.weight for a in m.attns])
    assert all(bool(g.abs().sum() > 0) for g in grads)
    assert prenorm_linear_attention_differentiable.autograd_calls == before  # counted on CUDA only


def test_wrapper_runs_plain_on_the_cpu_and_refuses_a_gradient():
    p = {k: torch.from_numpy(v) for k, v in _params(64, seed=1).items()}
    x = torch.from_numpy(_x(4, 24, 64, seed=2))
    n = prenorm_linear_attention.launches
    got = prenorm_linear_attention(x, p["g"], p["wqkv"], p["wout"], p["bout"])
    assert prenorm_linear_attention.launches == n
    torch.testing.assert_close(got, prenorm_linear_attention_reference(x, p["g"], p["wqkv"], p["wout"],
                                                                       p["bout"]), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="prenorm_linear_attention_differentiable"):
        prenorm_linear_attention(x.requires_grad_(True), p["g"], p["wqkv"], p["wout"], p["bout"])
    with pytest.raises(TypeError, match="float32"):
        prenorm_linear_attention(x.detach().double(), p["g"], p["wqkv"], p["wout"], p["bout"])


# -- the kernel's plan, which the C source mirrors


@pytest.mark.parametrize("C,T", FLAGSHIP + LONG, ids=lambda v: str(v))
def test_plan_fits_the_card(C, T):
    """One CTA an SM in shared memory; whole samples a tile, and at the
    flagship's T no more than 8 padding rows of 128."""
    _build.check_attention(C, T)
    plan = _build.plan_attention(5376, T, C)
    assert plan.smem_bytes == _build.attention_smem_bytes() <= _build.SMEM_MAX
    assert plan.rows == plan.samples * T <= _build.ATTN_ROWS and plan.samples >= 1
    assert (C, T) in LONG or _build.ATTN_ROWS - plan.rows <= 8


@pytest.mark.parametrize("B", [5376, 5000, 512])
def test_plan_tiles_ctas_and_weight_bytes(B):
    """Each flagship block's tiles (whole samples of 128 rows), persistent
    CTAs (one an SM at most), cluster and laid-out weight bytes read from
    L2 (both planes of wqkv and wout once a tile)."""
    samples = {24: 5, 12: 10, 6: 21, 3: 42}
    for C, T in FLAGSHIP:
        plan = _build.plan_attention(B, T, C)
        tiles = -(-B // samples[T])
        per_tile = 2 * 4 * (C * 384 + 128 * -(-C // 64) * 64)  # wqkv in N tiles of 128, wout of 64
        assert (plan.samples, plan.tiles, plan.ctas, plan.cluster) == (samples[T], tiles, min(tiles, 132), 1)
        assert plan.weight_bytes == tiles * per_tile == tiles * _build.attention_weight_bytes(C)
    assert _build.plan_attention(B, 3, 512, num_sms=66).ctas == min(66, -(-B // 42))


@pytest.mark.parametrize("C,T,why", [(1024, 0, "T=0"), (40, 24, "multiple of 16"),
                                     (64, 97, "T=97"), (0, 3, "multiple of 16")])
def test_plan_refuses_what_the_kernel_does_not_take(C, T, why):
    with pytest.raises(ValueError, match=why):
        _build.check_attention(C, T)


def test_plan_takes_the_parents_domain():
    """Every (C, T) that the 48- and 96-row tiles took (C a multiple of 16,
    T <= 96, [M][C + 4] and [M][392] floats within shared memory) is taken,
    and more: C = 1024 at T = 3, C = 512 at T = 35."""
    for T in (1, 3, 24, 48, 49, 96):
        M = 48 if T <= 48 else 96
        for C in range(16, 2049, 16):
            if 4 * M * (max(C + 4, 132) + 392) <= _build.SMEM_MAX:
                _build.check_attention(C, T)
    _build.check_attention(1024, 3)
    _build.check_attention(512, 35)


def test_c_source_mirrors_the_plan():
    src = (Path(_build.CSRC) / "linear_attention.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kRows") == _build.ATTN_ROWS
    assert const("kMaxT") == _build.ATTN_MAX_T
    assert const("kCMultiple") == _build.ATTN_C_MULTIPLE
    assert const("kQkvNt") == _build.ATTN_QKV_NT
    assert const("kOutNt") == _build.ATTN_OUT_NT
    assert const("kStages") == _build.ATTN_STAGES
    assert const("kSlotBytes") == _build.ATTN_SLOT_BYTES
    assert const("kQkvStride") == _build.ATTN_QKV_STRIDE
    assert f"({_build.attention_smem_bytes():,} bytes)" in src
    assert re.search(r"kRows / T, 0\}", src) and "(B + a.samples - 1) / a.samples" in src


def test_forward_profile_groups_every_op_by_module():
    """``tools/forward_profile.forward_ops`` on the CPU (CPU ms): every
    module range of one TemporalUnet1D forward holds ops, the attention
    group its 8 blocks with their (C, T), and the groups sum to the whole."""
    from cindm_tpu_torch.tools.forward_profile import GROUPS, forward_ops

    m = TemporalUnet1D(24, 8, dim=16).eval()
    rec = forward_ops(torch, torch.device("cpu"), m, batch=2)
    assert set(rec["groups"]) == set(GROUPS)
    assert rec["groups"]["attention"]["modules"] == 8 and rec["groups"]["attention"]["launches"] > 0
    assert [rec["modules"][f"attention.{k}"]["shape_C_T"] for k in range(8)] == [
        (16, 24), (32, 12), (64, 6), (128, 3), (128, 3), (64, 3), (32, 6), (16, 12)]
    for kind, n in (("down", 3), ("up", 3), ("head", 1), ("final_conv", 1), ("time_mlp", 1)):
        assert rec["groups"][kind]["modules"] == n and rec["groups"][kind]["launches"] > 0, kind
    assert rec["groups"]["fused_rtb"]["modules"] == 16 and rec["groups"]["fused_rtb"]["launches"] > 0
    total = sum(g["ms"] for g in rec["groups"].values())
    assert abs(total - rec["cpu_ms"]) <= 1e-6 * max(total, 1.0)
    assert sum(o["launches"] for o in rec["ops"].values()) == sum(g["launches"] for g in rec["groups"].values())


@pytest.mark.parametrize("variant", ["base", "noattn", "noqkv", "noout", "nol2", "noload"])
def test_ablation_variants_patch_the_kernel_once(variant):
    """``tools/attention_ablation``'s cuts each find their one place in the
    kernel's source, and change it unless the variant is the kernel itself."""
    from cindm_tpu_torch.tools.attention_ablation import VARIANTS, patched

    src = (Path(_build.CSRC) / "linear_attention.cu").read_text()
    assert set(VARIANTS) == {"base", "noattn", "noqkv", "noout", "nol2", "noload"}
    assert (patched(variant) == src) == (variant == "base")
