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
