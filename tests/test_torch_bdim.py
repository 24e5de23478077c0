"""Parity of the port's batched BDIM solver (cindm_tpu_torch.physics.bdim)
with cindm_tpu.physics.bdim at small grids (n = 16), and the rule that
batched designs never couple.

The port's fields are [D, N, N]; each JAX function works on one design
[N, N], so a port result for design d is held against the JAX result on
design d. Designs are real airfoil shapes from the port's
``data.airfoil`` helpers, scaled to the grid, some with edge-padded points.
Tolerances: field operators and the geometry 1e-5 of the largest
magnitude, the CG solve 1e-5, five solver steps of either branch 1e-4 of
each field's max magnitude, forces and closed-loop scores (utils.eval2d) 1e-3 relative;
batched against alone 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.physics import bdim as jb
from cindm_tpu.utils import eval2d as jev
from cindm_tpu_torch.data.airfoil import boundary_coords, sample_boundary_params
from cindm_tpu_torch.physics import bdim as tb
from cindm_tpu_torch.utils import eval2d as tev

N_GRID = 16
CFG = dict(n=N_GRID, cg_iters=60)
OP_TOL = 1e-5
STEP_TOL = 1e-4
FORCE_TOL = 1e-3
BATCH_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _sqrt_warmed_up():
    """torch's CPU sqrt can return values ~2.3e-4 off (relative) on its
    first call in a process, and values within 1 ulp on every later call.
    ``tests/torch_sqrt_first_call.py`` reproduces it with numpy and torch
    alone, on a loaded machine (torch 2.13 CPU), with and without JAX
    imported. The geometry here is held to 1e-5, so one sqrt runs before
    the tests."""
    torch.sqrt(torch.rand(8))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _design(seed, k=2, pad=6):
    """[k, M, 2] airfoil polygons on the n = 16 grid, the last point of the
    second repeated ``pad`` times (edge padding, as design_2d pads)."""
    rng = np.random.default_rng(seed)
    polys = []
    for i in range(k):
        p = boundary_coords(sample_boundary_params(rng, grid=N_GRID, y_band=(0.2 + 0.3 * i,) * 2))
        polys.append(p)
    polys[-1] = np.pad(polys[-1][: len(polys[-1]) - pad], ((0, pad), (0, 0)), mode="edge")
    return np.stack(polys).astype(np.float32)


def _field(seed, n=N_GRID + 2):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, n)).astype(np.float32)


def t1(a):
    """numpy [N, N] (or anything) -> a torch batch of one design."""
    return torch.from_numpy(np.asarray(a))[None]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_polygon_sdf_matches(k):
    coords = _design(k, k=k) if k > 1 else _design(1, k=1, pad=0)
    qx, qy = np.meshgrid(np.linspace(-1, 17, 23, dtype=np.float32),
                         np.linspace(-1, 17, 19, dtype=np.float32), indexing="ij")
    want = np.asarray(jb.multi_polygon_sdf(jnp.asarray(coords), jnp.asarray(qx), jnp.asarray(qy)))
    got = tb.multi_polygon_sdf(torch.from_numpy(coords), torch.from_numpy(qx), torch.from_numpy(qy))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= OP_TOL
    # one polygon alone, and a batch of designs [D, K, M, 2]
    one = tb.polygon_sdf(torch.from_numpy(coords[0]), torch.from_numpy(qx), torch.from_numpy(qy))
    assert _rel(one.numpy(), jb.polygon_sdf(jnp.asarray(coords[0]), qx, qy)) <= OP_TOL
    both = tb.multi_polygon_sdf(torch.from_numpy(np.stack([coords, coords[::-1]])),
                                torch.from_numpy(qx), torch.from_numpy(qy))
    np.testing.assert_allclose(both[0].numpy(), got.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(both[1].numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_make_consts_matches():
    cfg_j, cfg_t = jb.BDIMConfig(**CFG), tb.BDIMConfig(**CFG)
    coords = _design(3)
    want = jb.make_consts(cfg_j, jnp.asarray(coords))
    got = tb.make_consts(cfg_t, torch.from_numpy(coords)[None])
    for name, w, g in zip(want._fields, want, got):
        assert _rel(g[0].numpy(), w) <= OP_TOL, name


def _ops():
    u, v, p = _field(1), _field(2), _field(3)
    c = np.abs(_field(4)) / 1.5
    wnx, wny = _field(5) / 1.5, _field(6) / 1.5
    rng = np.random.default_rng(7)
    qx = rng.uniform(-2, N_GRID + 4, (40,)).astype(np.float32)
    qy = rng.uniform(-2, N_GRID + 4, (40,)).astype(np.float32)
    d = rng.uniform(-1, 1, (50,)).astype(np.float32)
    coords = _design(8)
    return [
        ("delta0", lambda m, T: m.delta0(T(d))),
        ("delta1", lambda m, T: m.delta1(T(d), 2.0)),
        ("set_bc_u", lambda m, T: m.set_bc_u(T(u), 1.0)),
        ("set_bc_v", lambda m, T: m.set_bc_v(T(v))),
        ("set_bc_p", lambda m, T: m.set_bc_p(T(p))),
        ("_bilinear", lambda m, T: m._bilinear(T(p), T(qx), T(qy))),
        ("_quadratic", lambda m, T: m._quadratic(T(p), T(qx), T(qy))),
        ("advect_single_u", lambda m, T: m.advect_single(T(u), T(u), T(v), 1.0, 1)),
        ("advect_single_v", lambda m, T: m.advect_single(T(v), T(u), T(v), 1.0, 2)),
        ("advect_double_u", lambda m, T: m.advect_double(T(p), T(u), T(v), T(wnx), T(wny), 1.0, 1)),
        ("advect_double_v", lambda m, T: m.advect_double(T(p), T(u), T(v), T(wnx), T(wny), 1.0, 2)),
        ("adv_dif_u", lambda m, T: m.adv_dif(T(u), T(u), T(v), 0.01, 1)),
        ("adv_dif_v", lambda m, T: m.adv_dif(T(v), T(u), T(v), 0.01, 2)),
        ("cfl_dt", lambda m, T: m.cfl_dt(T(u), T(v), 0.01)),
        ("divergence", lambda m, T: m.divergence(T(u), T(v))),
        ("gradient", lambda m, T: m.gradient(T(p))[0] + 2 * m.gradient(T(p))[1]),
        ("normal_grad", lambda m, T: m.normal_grad(T(p), T(wnx), T(wny))),
        ("poisson_matvec", lambda m, T: m.poisson_matvec(T(c), T(c[::-1].copy()), T(p))),
        ("press_force", lambda m, T: m.press_force(T(p), T(coords[1]))),
        ("momentum_balance_drag", lambda m, T: m.momentum_balance_drag(T(u), T(p))),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _ops()])
def test_field_operator_matches(name):
    fn = dict(_ops())[name]
    want = np.asarray(fn(jb, jnp.asarray))
    got = fn(tb, t1)[0].numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= OP_TOL


def test_poisson_solve_cg_matches():
    cfg = tb.BDIMConfig(**CFG)
    consts = tb.make_consts(cfg, torch.from_numpy(_design(9))[None])
    cx, cy = consts.del_x[0].numpy(), consts.del_y[0].numpy()
    b, x0 = _field(10), 0.1 * _field(11)
    want = jax.jit(jb.poisson_solve_cg, static_argnums=4)(cx, cy, b, x0, 60)
    got = tb.poisson_solve_cg(t1(cx), t1(cy), t1(b), t1(x0), 60)[0]
    assert _rel(got.numpy(), want) <= OP_TOL


def test_five_quick_steps_match():
    """Five steps of the QUICK + viscous branch (``bdim_step_quick``), every
    field with its ghost ring; the semi-Lagrangian ``bdim_step`` is held
    over five steps by the next test, whose JAX side compiles it once."""
    kw = dict(CFG, quick=True, nu=0.01)
    cfg_j, cfg_t = jb.BDIMConfig(**kw), tb.BDIMConfig(**kw)
    coords = np.stack([_design(12), _design(13)])
    step = jax.jit(functools.partial(jb.bdim_step, cfg_j))
    consts_t = tb.make_consts(cfg_t, torch.from_numpy(coords))
    state_t = tb.init_state(cfg_t, 2, device="cpu")
    with torch.no_grad():
        for _ in range(5):
            state_t = tb.bdim_step(cfg_t, consts_t, state_t)
    for d in range(2):
        consts_j = jb.make_consts(cfg_j, jnp.asarray(coords[d]))
        state_j = jb.init_state(cfg_j)
        for _ in range(5):
            state_j = step(consts_j, state_j)
        for name, w, g in zip(state_j._fields, state_j, state_t):
            assert _rel(g[d].numpy(), w) <= STEP_TOL, (d, name)


def test_simulate_flow_batch_forces_match():
    """Two designs over 3 + 2 steps of ``bdim_step``: the recorded fields
    after steps 4 and 5 within 1e-4, the forces within 1e-3."""
    cfg_j, cfg_t = jb.BDIMConfig(**CFG), tb.BDIMConfig(**CFG)
    coords = np.stack([_design(14), _design(15)])
    (ju, jv, jp), jf = jb.simulate_flow_batch(cfg_j, jnp.asarray(coords), 3, 2)
    (tu, tv, tp), tf = tb.simulate_flow_batch(cfg_t, coords, 3, 2, device="cpu")
    assert tf.shape == (2, 2, 2, 2) and tu.shape == (2, 2, N_GRID, N_GRID)
    assert _rel(tf.numpy(), jf) <= FORCE_TOL
    for w, g in ((ju, tu), (jv, tv), (jp, tp)):
        assert _rel(g.numpy(), w) <= STEP_TOL


def test_evaluate_designs_matches():
    """Closed-loop scoring (utils.eval2d) on the designs of the test above
    (the JAX side reuses its compiled solver)."""
    coords = np.stack([_design(14), _design(15)])
    want = jev.evaluate_designs(coords, jb.BDIMConfig(**CFG), n_warmup=3, n_record=2)
    got = tev.evaluate_designs(coords, tb.BDIMConfig(**CFG), n_warmup=3, n_record=2, device="cpu")
    assert set(got) == set(want)
    assert _rel(got["forces"], want["forces"]) <= FORCE_TOL
    for k, v in want.items():
        if np.ndim(v) == 0:
            assert abs(got[k] - v) <= FORCE_TOL * abs(v), k


def test_batched_designs_do_not_couple():
    """Two different designs batched give each one's result alone: every
    per-design reduction (exit flux, pressure mean, CG inner products)
    reduces over that design only."""
    cfg = tb.BDIMConfig(**CFG)
    coords = np.stack([_design(16), _design(17, k=2, pad=0)])
    (bu, bv, bp), bf = tb.simulate_flow_batch(cfg, coords, 3, 2, device="cpu")
    for d in range(2):
        (au, av, ap), af = tb.simulate_flow_batch(cfg, coords[d:d + 1], 3, 2, device="cpu")
        for a, b in ((au, bu), (av, bv), (ap, bp), (af, bf)):
            assert _rel(b[d].numpy(), a[0].numpy()) <= BATCH_TOL
    assert _rel(bf[0].numpy(), bf[1].numpy()) > 1e-2  # the designs do differ


def test_drivers_default_to_the_card():
    """The solver's drivers place arrays on the card unless the CPU is asked
    for by name, and never fall back to it; a tensor keeps its own device."""
    cfg = tb.BDIMConfig(n=8, cg_iters=2)
    coords = _design(18, k=1, pad=0)[0] * 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tb.init_state(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tb.simulate_flow_batch(cfg, coords[None], 1, 1)
        with pytest.raises(RuntimeError, match="cuda"):
            tb.simulate_flow(cfg, coords, 1, 1)
    (u, _, _), f = tb.simulate_flow(cfg, torch.from_numpy(coords), 1, 1)
    assert u.device.type == "cpu" and f.shape == (1, 1, 2)
