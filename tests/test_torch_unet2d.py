"""Parity of the port's 2D models (cindm_tpu_torch.models.unet2d) with
cindm_tpu.models.unet2d: each block alone, Unet2D and ForceUnet at small
width on a seeded JAX parameter tree of their own structure, the weight round trip,
and the two in-tree snapshots at full width (32 x 32 inputs: the nets are
convolutional, and the JAX side compiles faster at that size).

Inputs are NHWC numpy arrays from a seed; the port's models take NCHW, so
the tests transpose at the boundary. Tolerance: max |diff| over the JAX
output's max magnitude, 1e-5 at small width, 1e-4 for the snapshots."""

import os

import jax
import numpy as np
import pytest
import torch

from cindm_tpu.models import unet2d as ju
from cindm_tpu_torch.models import ForceUnet, Unet2D, flax_from_params, params_from_flax
from cindm_tpu_torch.models import unet2d as tu
from cindm_tpu_torch.utils.persist import load_flax_npz, select_subtree
from torch_port_helpers import keystr_flat, nest

REPO = os.path.join(os.path.dirname(__file__), "..")

SMALL_TOL = 1e-5
SNAPSHOT_TOL = 1e-4


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load_block(module, params):
    """Load a block's own Flax parameters ({'params': {...}}) into the port block."""
    flat = {tuple(k.strip("[]'").split("']['")): v
            for k, v in keystr_flat(params["params"]).items()}
    sd = {}
    for fp, pk, tr in tu._mapping(module, (), ""):
        arr = np.asarray(flat.pop(fp), np.float32)
        sd[pk] = torch.from_numpy(np.ascontiguousarray(tr(arr) if tr else arr))
    assert not flat, sorted(flat)
    module.load_state_dict(sd, strict=True)
    return module


def _perturbed(params, seed):
    """The JAX init with every leaf moved by noise, so that norm gains and
    biases are exercised away from 1 and 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32), params)


def _seeded_tree(jm, seed, *args):
    """A parameter tree of the JAX model's own structure (``jax.eval_shape``
    of its init, which is quick where compiling the init is not), filled
    from a numpy seed: kernels ~ N(0, 1/fan_in), gains 1 + noise, biases
    noise."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.PRNGKey(seed), *args))


X16 = np.random.default_rng(0).standard_normal((2, 16, 16, 8)).astype(np.float32)


@pytest.mark.parametrize("kind", ["WSConv2d", "Downsample2D", "Upsample2D", "LinearAttention2D",
                                  "Attention2D"])
def test_block_matches(kind):
    g = torch.Generator().manual_seed(0)
    jm, tm = {
        "WSConv2d": (ju.WSConv2d(12, 3), tu.WSConv2d(8, 12, 3, generator=g)),
        "Downsample2D": (ju.Downsample2D(12), tu.Downsample2D(8, 12, generator=g)),
        "Upsample2D": (ju.Upsample2D(12), tu.Upsample2D(8, 12, generator=g)),
        "LinearAttention2D": (ju.LinearAttention2D(8, heads=2, dim_head=4),
                              tu.LinearAttention2D(8, heads=2, dim_head=4, generator=g)),
        "Attention2D": (ju.Attention2D(8, heads=2, dim_head=4),
                        tu.Attention2D(8, heads=2, dim_head=4, generator=g)),
    }[kind]
    params = _perturbed(jm.init(jax.random.PRNGKey(1), X16), 1)
    want = jm.apply(params, X16)
    got = nhwc(_load_block(tm, params)(nchw(X16)))
    assert got.shape == want.shape
    assert _rel(got, want) <= SMALL_TOL


def test_pixel_unshuffle_matches_jax_reshape():
    """Downsample2D's channel order c*4 + dh*2 + dw is F.pixel_unshuffle's."""
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    B, H, W, C = x.shape
    want = x.reshape(B, H // 2, 2, W // 2, 2, C).transpose(0, 1, 3, 5, 2, 4).reshape(
        B, H // 2, W // 2, C * 4)
    got = nhwc(torch.nn.functional.pixel_unshuffle(nchw(x), 2))
    np.testing.assert_array_equal(got, want)


def _small_models():
    return [
        ("unet", ju.Unet2D(dim=8, dim_mults=(1, 2), channels=21),
         Unet2D(dim=8, dim_mults=(1, 2), channels=21)),
        ("force", ju.ForceUnet(dim=8, dim_mults=(1, 2)), ForceUnet(dim=8, dim_mults=(1, 2))),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["Unet2D", "ForceUnet"])
def test_small_model_matches_and_round_trips(which):
    name, jm, tm = _small_models()[which]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 21 if name == "unet" else 4)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    args = (x, t) if name == "unet" else (x,)
    params = _seeded_tree(jm, 2, *args)
    want = np.asarray(jax.jit(jm.apply)(params, *args))
    tm.load_state_dict(params_from_flax(params, tm))
    with torch.no_grad():
        out = tm(nchw(x), torch.from_numpy(t).long()) if name == "unet" else tm(nchw(x))
    got = nhwc(out) if name == "unet" else out.numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= SMALL_TOL
    # the round trip gives the JAX tree back, key for key and bit for bit
    back = flax_from_params(tm)
    flat = keystr_flat(params["params"])
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("which", ["airfoil", "force"])
def test_in_tree_snapshot_forward_matches(which):
    path, jm, tm, C = {
        "airfoil": ("results/airfoil_v3/persisted_m60000.npz", ju.Unet2D(dim=64, dim_mults=(1, 2)),
                    Unet2D(dim=64, dim_mults=(1, 2)), 21),
        "force": ("results/force_v3/persisted_m8000.npz", ju.ForceUnet(), ForceUnet(), 4),
    }[which]
    tree = select_subtree(load_flax_npz(os.path.join(REPO, path)), "ema_params")
    tm.load_state_dict(params_from_flax(tree, tm))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 32, 32, C)).astype(np.float32)
    t = np.array([5, 600], np.int32)
    jp = {"params": nest({k.removeprefix("['params']"): v for k, v in tree.items()})}
    if which == "airfoil":
        want = np.asarray(jax.jit(jm.apply)(jp, x, t))
        with torch.no_grad():
            got = nhwc(tm(nchw(x), torch.from_numpy(t).long()))
    else:
        want = np.asarray(jax.jit(jm.apply)(jp, x))
        with torch.no_grad():
            got = tm(nchw(x)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= SNAPSHOT_TOL
