"""Parity of the port's TemporalUnet1D (models/) and its Flax weight loader
with cindm_tpu.models.TemporalUnet1D.apply."""

import json
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import linen as nn

from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.models.blocks import Upsample1d as JaxUpsample1d
from cindm_tpu_torch.models import TemporalUnet1D, flax_from_params, params_from_flax
from cindm_tpu_torch.models.blocks import Upsample1d
from cindm_tpu_torch.utils.persist import (
    bf16_bits_to_f32,
    load_flax_npz,
    parse_keypath,
    select_subtree,
)

SNAPSHOT = "results/nbody2_coll/persisted_m200000.npz"
TOL = dict(rtol=1e-4, atol=1e-4)


def _random_flax_params(model, seed):
    """Random values for every leaf of ``model``'s Flax parameter tree (shapes
    from ``jax.eval_shape`` of its init); norm gains and biases are perturbed
    away from 1 and 0 so they are exercised too."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 8)),
                            jnp.zeros(1, jnp.int32))
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
def small():
    """A dim-16 Flax model with random parameters, and the port loaded from it."""
    jm = JaxUnet(horizon=24, transition_dim=8, dim=16)
    params = _random_flax_params(jm, seed=0)
    tm = TemporalUnet1D(24, 8, dim=16)
    tm.load_state_dict(params_from_flax(params, tm))
    return jax.jit(jm.apply), params, tm


@pytest.mark.parametrize("t", [0, 1, 250, 999])
def test_forward_matches_flax_dim16(small, t):
    apply, params, tm = small
    x = np.random.default_rng(t).standard_normal((3, 24, 8)).astype(np.float32)
    tt = np.full((3,), t, np.int32)
    want = np.asarray(apply(params, x, tt))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_plain_path_equals_kernel_path_on_cpu(small):
    _, _, tm = small
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 24, 8)).astype(np.float32))
    t = torch.tensor([5, 600])
    with torch.no_grad():
        torch.testing.assert_close(tm(x, t), tm(x, t, use_kernels=False), rtol=0, atol=0)


def test_flax_round_trip(small):
    _, params, tm = small
    flat = flax_from_params(tm)
    want = {k: v for k, v in _flatten(params["params"]).items()}
    assert set(flat) == set(want)
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = np.asarray(v)
    return out


def test_params_from_flax_names_the_faulty_keys(small):
    _, params, tm = small
    flat = _flatten(params["params"])
    extra = dict(flat)
    extra["['Bogus_0']['kernel']"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="Bogus_0"):
        params_from_flax(extra, tm)
    missing = {k: v for k, v in flat.items() if "Upsample1d_1" not in k}
    with pytest.raises(ValueError, match="Upsample1d_1"):
        params_from_flax(missing, tm)
    wrong = dict(flat)
    key = "['ResidualTemporalBlock_3']['Dense_0']['Dense_0']['kernel']"
    wrong[key] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="ResidualTemporalBlock_3"):
        params_from_flax(wrong, tm)
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(flat, TemporalUnet1D(24, 8, dim=32))


def test_upsample_matches_flax_conv_transpose():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    jm = JaxUpsample1d(12)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(p, x))
    tm = Upsample1d(12, generator=torch.Generator().manual_seed(0))
    k = np.asarray(p["params"]["ConvTranspose_0"]["kernel"])
    tm.weight.data = torch.from_numpy(np.ascontiguousarray(np.transpose(k[::-1], (1, 2, 0))))
    tm.bias.data = torch.tensor(np.asarray(p["params"]["ConvTranspose_0"]["bias"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_decode_matches_ml_dtypes():
    vals = np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 100
    vals = np.concatenate([vals, [0.0, -0.0, np.inf, -np.inf, 1e-40]]).astype(np.float32)
    bits = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(bf16_bits_to_f32(bits), want)


def test_parse_keypath():
    assert parse_keypath("['a']['b_0']['kernel']") == ("a", "b_0", "kernel")
    with pytest.raises(ValueError):
        parse_keypath("a.b")


def _jax_ema_tree(path):
    """The snapshot's EMA params as a nested Flax tree, decoded with ml_dtypes."""
    tree = {}
    with np.load(path) as d:
        overrides = json.loads(bytes(d["__dtype_overrides__"]).decode())
        for k in d.files:
            if not k.startswith("['ema_params']"):
                continue
            arr = d[k]
            if overrides.get(k) == "bfloat16":
                arr = arr.view(ml_dtypes.bfloat16).astype(np.float32)
            node = tree
            *parents, leaf = re.findall(r"\['([^']*)'\]", k)[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return tree


def test_forward_matches_flax_on_in_tree_bf16_snapshot():
    """Full width (dim 64) on the committed 2-body prior, stored as bf16."""
    flat = load_flax_npz(SNAPSHOT)
    assert all(v.dtype != np.uint16 for v in flat.values())
    tm = TemporalUnet1D(24, 8, dim=64)
    tm.load_state_dict(params_from_flax(select_subtree(flat, "ema_params"), tm))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 24, 8)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    want = np.asarray(jax.jit(JaxUnet(horizon=24, transition_dim=8, dim=64).apply)(
        _jax_ema_tree(SNAPSHOT), x, t))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
