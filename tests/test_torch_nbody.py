"""Parity of the port's n-body simulator (physics/) with cindm_tpu.physics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.physics import nbody as jnb
from cindm_tpu.sampling.guidance import get_eval_fn as jax_eval_fn
from cindm_tpu_torch.physics import nbody as tnb
from cindm_tpu_torch.sampling.guidance import get_eval_fn

TOL = dict(rtol=0, atol=1e-4)  # box units (0..200)


def _head_on():
    """Two bodies meeting head-on, one heading for the bottom wall, one at rest."""
    return np.array([[
        [50.0, 100.0, 100.0, 0.0],
        [150.0, 100.0, -100.0, 0.0],
        [100.0, 40.0, 10.0, -80.0],
        [170.0, 170.0, 0.0, 0.0],
    ]], np.float32)


def _random_states():
    return np.array(jnb.generate_initial_states(jax.random.PRNGKey(0), 3, 5, v_max=60.0))


@pytest.mark.parametrize("states", ["head_on", "random"])
def test_simulate_matches(states):
    s0 = _head_on() if states == "head_on" else _random_states()
    n_steps = 80
    want = np.asarray(jnb.simulate(jnp.asarray(s0), n_steps))
    got = tnb.simulate(torch.from_numpy(s0), n_steps).numpy()
    assert got.shape == want.shape == (s0.shape[0], n_steps, s0.shape[1], 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_head_on_collision_happens():
    traj = tnb.simulate(torch.from_numpy(_head_on()), 40).numpy()
    assert traj[0, 0, 0, 2] > 0 and traj[0, -1, 0, 2] < 0  # body 0 bounced back
    assert traj[0, -1, 2, 3] > 0  # body 2 bounced off the bottom wall


def test_eval_simu_matches():
    s0 = _random_states()
    n_bodies = s0.shape[1]
    cond = (s0.reshape(s0.shape[0], 1, n_bodies * 4) / 200.0).astype(np.float32)
    target = np.array([0.5, 0.5], np.float32)
    want_traj, want_obj = jnb.eval_simu(jnp.asarray(cond), jax_eval_fn(jnp.asarray(target), 1),
                                        n_bodies, rollout_steps=12)
    got_traj, got_obj = tnb.eval_simu(torch.from_numpy(cond), get_eval_fn(torch.from_numpy(target), 1),
                                      n_bodies, rollout_steps=12)
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(want_traj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got_obj), float(want_obj), rtol=1e-5)


def test_generate_initial_states_are_valid():
    g = torch.Generator().manual_seed(0)
    s = tnb.generate_initial_states(g, 64, 8, v_max=50.0)
    assert s.shape == (64, 8, 4)
    pos, vel = s[..., :2], s[..., 2:]
    r = tnb.RADIUS
    assert bool(((pos >= r) & (pos <= tnb.WIDTH - r)).all())
    assert bool((vel.abs() <= 50.0).all())
    d = torch.linalg.norm(pos[:, :, None] - pos[:, None], dim=-1) + torch.eye(8) * 1e3
    assert bool((d >= 2 * r).all())
