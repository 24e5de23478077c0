"""Parity of the port's airfoil dataset (cindm_tpu_torch.data.airfoil) with
cindm_tpu.data.airfoil: windowing, batches and the batch iterator exactly on
one seeded data dict; the device sampler's gather against get_batch; the
simulation generator on 2 simulations of a few steps (boundary, mask and
offset exact, each field within 1e-5 of its max magnitude, forces 1e-3);
each package reading the other's simulation cache and prep cache; the
reference on-disk layout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.data import airfoil as ja
from cindm_tpu.physics.bdim import BDIMConfig as JBDIMConfig
from cindm_tpu_torch.data import airfoil as ta
from cindm_tpu_torch.physics.bdim import BDIMConfig as TBDIMConfig

FIELD_TOL = 1e-5  # max |d| / max |JAX| per field
FORCE_TOL = 1e-3
SIM_CFG = dict(n_warmup=2, time_stamps=2)  # a few solver steps


def _data(S=3, T=24, seed=0):
    """A data dict in the generator's layout (not physical: both packages
    only have to window it alike)."""
    rng = np.random.default_rng(seed)
    return {
        "fields": rng.standard_normal((S, T, 62, 62, 3)).astype(np.float32),
        "boundary": rng.uniform(1, 61, (S, 40, 2)).astype(np.float32),
        "mask": (rng.uniform(size=(S, 62, 62)) > 0.9).astype(np.float32),
        "offset": rng.uniform(-0.5, 0.5, (S, 62, 62, 2)).astype(np.float32),
        "forces": rng.standard_normal((S, T, 1, 2)).astype(np.float32),
    }


CFGS = {
    "prior": dict(input_steps=2, output_steps=4, time_interval=2, time_stamps=24),
    "baseline": dict(input_steps=1, output_steps=3, time_interval=1, time_stamps=24),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_windows_and_batches_exact(name):
    data = _data()
    jd = ja.AirfoilDataset(data, ja.AirfoilDatasetConfig(**CFGS[name]))
    td = ta.AirfoilDataset(data, ta.AirfoilDatasetConfig(**CFGS[name]))
    assert len(td) == len(jd) > 0
    for idx in (0, len(jd) // 2, len(jd) - 1):
        jw, tw = jd.get_window(idx), td.get_window(idx)
        assert set(jw) == set(tw)
        for k in jw:
            np.testing.assert_array_equal(tw[k], jw[k])
    idx = np.array([len(jd) - 1, 0, 3])
    jb, tb = jd.get_batch(idx), td.get_batch(idx)
    for k in ("x", "cond"):
        np.testing.assert_array_equal(tb[k], jb[k])
    jit, tit = jd.iterate_batches(2, seed=5), td.iterate_batches(2, seed=5)
    for _ in range(len(jd)):  # past the first epoch's end
        a, b = next(jit), next(tit)
        for k in ("x", "cond"):
            np.testing.assert_array_equal(b[k], a[k])
    assert len(list(td.iterate_batches(2, seed=1, loop=False))) == len(jd) // 2


def test_device_sampler_gather_equals_get_batch(tmp_path):
    data = _data()
    cfg = ta.AirfoilDatasetConfig(**CFGS["prior"])
    ds = ta.AirfoilDataset(data, cfg)
    prep = str(tmp_path / "flatrows_v1.npy")
    draw = ds.make_device_sampler(3, device="cpu", prep_cache=prep)
    idx = np.array([0, 5, len(ds) - 1])
    sims, tids = np.divmod(idx, ds.time_stamps_effective)
    mids = tids * cfg.time_interval + ds.t_cushion_input
    got = draw.gather(draw.arrays, torch.from_numpy(sims), torch.from_numpy(mids))
    want = ds.get_batch(idx)
    for k in ("x", "cond"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # a draw: the shapes of a batch, windows of the dataset
    b = draw(draw.arrays, torch.Generator().manual_seed(0))
    assert b["x"].shape == (3, 64, 64, 15) and b["cond"].shape == (3, 64, 64, 6)
    rows = {tuple(r) for r in ds.get_batch(np.arange(len(ds)))["x"].reshape(len(ds), -1)[:, :64]}
    assert all(tuple(r) in rows for r in b["x"].reshape(3, -1)[:, :64].numpy())
    # the JAX sampler reads the port's prep cache into the same batch
    jd = ja.AirfoilDataset(data, ja.AirfoilDatasetConfig(**CFGS["prior"]))
    jdraw = jd.make_device_sampler(3, prep_cache=prep)
    jgot = jdraw.gather(jdraw.arrays, jnp.asarray(sims), jnp.asarray(mids))
    np.testing.assert_array_equal(np.asarray(jgot["x"]), want["x"])
    # and the port reads a prep cache the JAX package wrote
    jprep = str(tmp_path / "jax_flatrows_v1.npy")
    jd.make_device_sampler(3, prep_cache=jprep)
    again = ds.make_device_sampler(3, device="cpu", prep_cache=jprep)
    np.testing.assert_array_equal(again.arrays["fields"].numpy(), draw.arrays["fields"].numpy())


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """Both packages' generator on the same 2 boundaries, each writing its
    cache."""
    root = tmp_path_factory.mktemp("airfoil_sims")
    jcache, tcache = str(root / "jax"), str(root / "torch")
    want = ja.generate_airfoil_sims(3, 2, ja.AirfoilDatasetConfig(**SIM_CFG), JBDIMConfig(),
                                    cache_dir=jcache)
    got = ta.generate_airfoil_sims(3, 2, ta.AirfoilDatasetConfig(**SIM_CFG), TBDIMConfig(),
                                   cache_dir=tcache, device="cpu")
    return want, got, jcache, tcache


def test_generate_airfoil_sims_matches(sims):
    want, got, _, _ = sims
    assert set(got) == set(want) == set(ta.CACHE_KEYS)
    for k in ("boundary", "mask", "offset"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["fields"].shape == want["fields"].shape == (2, 2, 62, 62, 3)
    for c in range(3):
        w = want["fields"][..., c]
        assert np.abs(got["fields"][..., c] - w).max() <= FIELD_TOL * np.abs(w).max(), c
    assert np.abs(got["forces"] - want["forces"]).max() <= FORCE_TOL * np.abs(want["forces"]).max()


def test_caches_read_across_packages(sims):
    want, got, jcache, tcache = sims
    cfg = dict(n_warmup=1, time_stamps=1)  # ignored: the caches hold the data
    from_jax = ta.generate_airfoil_sims(99, 2, ta.AirfoilDatasetConfig(**cfg), cache_dir=jcache,
                                        device="cpu")
    from_torch = ja.generate_airfoil_sims(99, 2, ja.AirfoilDatasetConfig(**cfg), cache_dir=tcache)
    for k in ta.CACHE_KEYS:
        np.testing.assert_array_equal(from_jax[k], want[k])
        np.testing.assert_array_equal(from_torch[k], got[k])
    assert sorted(os.listdir(jcache)) == sorted(os.listdir(tcache))


def test_generate_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ta.generate_airfoil_sims(0, 1, ta.AirfoilDatasetConfig(**SIM_CFG))


def test_load_reference_airfoil_dirs_matches(tmp_path):
    base = tmp_path / "training_trajectories"
    rng = np.random.default_rng(0)
    for k in range(2):
        sim = base / f"sim_{k:06d}"
        os.makedirs(sim)
        for t in range(3):
            np.save(sim / f"velocity_{t:06d}.npy", rng.normal(size=(2, 62, 62)).astype(np.float32))
            np.save(sim / f"pressure_{t:06d}.npy", rng.normal(size=(62, 62)).astype(np.float32))
        np.save(sim / "boundary.npy", rng.uniform(1, 61, size=(2, 40)).astype(np.float32))
    os.makedirs(base / "boundary_mask")
    os.makedirs(base / "boundary_offset")
    for k in range(2):
        np.save(base / "boundary_mask" / f"sim_{k:06d}.npy",
                rng.integers(0, 2, (62 * 62,)).astype(np.float32))
        np.save(base / "boundary_offset" / f"sim_{k:06d}.npy",
                rng.normal(size=(62 * 62, 2)).astype(np.float32))
    want = ja.load_reference_airfoil_dirs(str(tmp_path), n_sims=2, time_stamps=3)
    got = ta.load_reference_airfoil_dirs(str(tmp_path), n_sims=2, time_stamps=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
