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
# the horizon-70 direct model's blocks: 96-row tiles, and tiles with padding rows
LONG = [(64, 70), (128, 35)]
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


def _tf32(a):
    """tf32 with round-to-nearest, ties away (split_tf32_fast's big half)."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _small(a, big):
    """split_tf32_fast's small half: the exact rest a - big, which the tensor
    cores read as tf32 (its low 13 bits dropped)."""
    return ((a - big).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf3(a, b):
    """A product as the kernel issues it: small*big + big*small + big*big."""
    ab, bb = _tf32(a), _tf32(b)
    al, bl = _small(a, ab), _small(b, bb)
    acc = np.matmul(al, bb, dtype=np.float32)
    acc = acc + np.matmul(ab, bl, dtype=np.float32)
    return acc + np.matmul(ab, bb, dtype=np.float32)


def emulate(x, p, eps=EPS):
    """The kernel's decomposition: row tiles of whole samples (48 rows, 96
    where T > 48; padding rows and samples past the batch zero), the tile's
    LayerNorm, the q | k | v product of every head, then per (sample, head)
    k's softmax over T, the context k^T v and q context into the hidden
    tile, then the out product with bias and residual; only the rows of real
    samples kept."""
    B, T, C = x.shape
    M = _build.attention_rows(T)
    S = M // T
    tiles = -(-B // S)
    xs = np.zeros((tiles, M, C), np.float32)
    xs[:, :S * T] = np.concatenate([x, np.zeros((tiles * S - B, T, C), np.float32)]).reshape(tiles, S * T, C)
    mean = xs.sum(-1, keepdims=True, dtype=np.float32) / np.float32(C)
    var = np.square(xs - mean).sum(-1, keepdims=True, dtype=np.float32) / np.float32(C)
    xn = (xs - mean) * (np.float32(1) / np.sqrt(var + np.float32(eps))) * p["g"]
    qkv = _tf3(xn, p["wqkv"])[:, :S * T].reshape(tiles, S, T, 3, 4, 32)  # [.., q|k|v, head, 32]
    hid = np.zeros((tiles, M, HIDDEN), np.float32)
    for h in range(4):
        q, k, v = qkv[..., 0, h, :] * SCALE, qkv[..., 1, h, :], qkv[..., 2, h, :]
        e = np.exp(k - k.max(axis=2, keepdims=True))
        k = e / e.sum(axis=2, keepdims=True, dtype=np.float32)
        context = np.matmul(np.swapaxes(k, -1, -2), v, dtype=np.float32)  # [tiles, S, 32, 32]
        hid[:, :S * T, h * 32:(h + 1) * 32] = np.matmul(q, context, dtype=np.float32).reshape(tiles, S * T, 32)
    out = (_tf3(hid, p["wout"]) + p["bout"]) + xs
    return out[:, :S * T].reshape(tiles * S, T, C)[:B]


@pytest.mark.parametrize("C,T", FLAGSHIP + LONG,
                         ids=[f"C{c}-T{t}" + ("-mid" if i == 4 else "") for i, (c, t) in enumerate(FLAGSHIP + LONG)])
def test_emulated_kernel_matches_plain(C, T):
    """Batches 5 and 1, and one whose last tile holds one sample of several."""
    p = _params(C, seed=3 * C + T)
    S = _build.attention_rows(T) // T
    for B in dict.fromkeys((5, 1, 2 * S + 1)):
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


@pytest.mark.parametrize("C,T", FLAGSHIP + LONG + [(512, 35)], ids=lambda v: str(v))
def test_plan_fits_the_card(C, T):
    _build.check_attention(C, T)
    smem = _build.attention_smem_bytes(C, T)
    # two blocks an SM where C <= 128 at the flagship's T (one SM's 228 KB, 1 KB a block reserved)
    assert smem <= _build.SMEM_MAX and (C > 128 or T > 24 or 2 * (smem + 1024) <= 233472)


@pytest.mark.parametrize("C,T,why", [(1024, 3, "shared memory"), (40, 24, "multiple of 16"),
                                     (64, 97, "T=97"), (0, 3, "multiple of 16")])
def test_plan_refuses_what_the_kernel_does_not_take(C, T, why):
    with pytest.raises(ValueError, match=why):
        _build.check_attention(C, T)


def test_c_source_mirrors_the_plan():
    src = (Path(_build.CSRC) / "linear_attention.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kCMultiple") == _build.ATTN_C_MULTIPLE
    assert const("kQkvStride") == _build.ATTN_QKV_STRIDE
    assert const("kHidStride") == _build.ATTN_HIDDEN_STRIDE
    assert re.search(r"return T <= (\d+) \? (\d+) : (\d+);", src).groups() == tuple(
        map(str, (_build.ATTN_ROWS, _build.ATTN_ROWS, _build.ATTN_ROWS_LONG)))


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


@pytest.mark.parametrize("variant", ["base", "noattn", "noqkv", "noout", "nol2"])
def test_ablation_variants_patch_the_kernel_once(variant):
    """``tools/attention_ablation``'s cuts each find their one place in the
    kernel's source, and change it unless the variant is the kernel itself."""
    from cindm_tpu_torch.tools.attention_ablation import VARIANTS, patched

    src = (Path(_build.CSRC) / "linear_attention.cu").read_text()
    assert set(VARIANTS) == {"base", "noattn", "noqkv", "noout", "nol2"}
    assert (patched(variant) == src) == (variant == "base")
