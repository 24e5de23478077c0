"""Shared helpers of the port's parity tests: one set of weights for the
port's TemporalUnet1D and the JAX package's, moved as numpy arrays."""

import copy
import os
import re

import numpy as np
import torch

from cindm_tpu_torch.models import TemporalUnet1D, flax_from_params


def port_model(dim=16, seed=0, horizon=24, transition_dim=8, dim_mults=(1, 2, 4, 8)):
    """A port TemporalUnet1D with seeded weights whose norm gains and biases
    are moved away from 1 and 0, so that their gradients are exercised."""
    m = TemporalUnet1D(horizon, transition_dim, dim=dim, dim_mults=dim_mults,
                       generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(("norm.weight", "norm.g")):
                p.add_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
            elif name.endswith("norm.bias"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return m


def nest(flat):
    """{"['a']['b']": v} -> {"a": {"b": v}}."""
    tree = {}
    for k, v in flat.items():
        *parents, leaf = re.findall(r"\['([^']*)'\]", k)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flax_params(model):
    """The model's weights as the JAX package's parameter tree {'params': ...}."""
    return {"params": nest(flax_from_params(model))}


def flax_grads(model, grads):
    """Port gradients (one per ``model.parameters()``) in Flax names and
    layouts, flattened to key-path strings."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(shadow.parameters(), grads):
            p.copy_(g)
    return flax_from_params(shadow)


def keystr_flat(tree, prefix=""):
    """A nested dict of arrays flattened to key-path strings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(keystr_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = np.asarray(v)
    return out


def write_traj_cache(path, n_sims=4, n_steps=800, n_bodies=2, seed=0):
    """A trajectory cache in the datasets' layout [n_sims, n_steps, n, 4]:
    positions on slow random sinusoids in [20, 180] (bodies approach and
    part over hundreds of frames), random velocities in ±100. Not physical;
    both packages only have to window it alike."""
    rng = np.random.default_rng(seed)
    frames = np.arange(n_steps)[None, :, None, None]
    freq = rng.uniform(0.002, 0.02, (n_sims, 1, n_bodies, 2))
    phase = rng.uniform(0, 2 * np.pi, (n_sims, 1, n_bodies, 2))
    pos = 100 + 80 * np.sin(freq * frames + phase)
    vel = rng.uniform(-100, 100, (n_sims, n_steps, n_bodies, 2))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.concatenate([pos, vel], -1).astype(np.float32))
    return path


def tf32_rna(a):
    """float32 -> float32 rounded to tf32 (10 mantissa bits, the low 13 bits
    zero) to nearest with ties away from zero, as cvt.rna.tf32.f32 and the
    CUDA stage kernel round: ±inf stay, the largest floats round to ±inf, a
    NaN becomes the canonical NaN 0x7FFFFFFF."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
    r[np.isnan(a)] = 0x7FFFFFFF
    return r.view(np.float32)


def tf32_split(a):
    """(big, small) with big = tf32_rna(a) and small = tf32_rna(a - big)."""
    a = np.asarray(a, dtype=np.float32)
    big = tf32_rna(a)
    return big, tf32_rna(a - big)


def conv_gn_mish_3xtf32(x, w, b, gs, gb, groups=8, eps=1e-5, passes=3):
    """The CUDA stage kernel's arithmetic in plain torch on the CPU:
    Conv1d(pad K//2) with every product a*w taken as small(a)*big(w) +
    big(a)*small(w) + big(a)*big(w) (passes=3; passes=1 keeps big*big only,
    single-pass TF32), each tf32 x tf32 product exact in fp32 as in the
    tensor cores, then GroupNorm in fp32 and Mish. numpy in, torch out."""
    from cindm_tpu_torch.ops.fused_conv_gn import conv1d_same, group_norm, mish

    (xb, xs), (wb, ws) = tf32_split(x), tf32_split(w)
    t = torch.from_numpy
    y = conv1d_same(t(xb), t(wb), None)
    if passes == 3:
        y = conv1d_same(t(xs), t(wb), None) + conv1d_same(t(xb), t(ws), None) + y
    return mish(group_norm(y + t(np.asarray(b, np.float32)), t(np.asarray(gs, np.float32)),
                           t(np.asarray(gb, np.float32)), groups, eps))
