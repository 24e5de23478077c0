"""The port's n-body dataset (data/nbody.py) against the JAX package's
NBodyDataset on one numpy-written trajectory cache: windows, batches, the
collision-window mask and the batch sampler's index stream."""

import itertools

import numpy as np
import pytest
import torch

from cindm_tpu.data.nbody import NBodyDataset as JaxDataset
from cindm_tpu.data.nbody import NBodyDatasetConfig as JaxConfig
from cindm_tpu_torch.data import NBodyDataset, NBodyDatasetConfig, generate_trajectories
from torch_port_helpers import write_traj_cache


def _pair(tmp_path, cond_steps=0, n_bodies=2, **cache):
    n_sims = cache.get("n_sims", 4)
    path = write_traj_cache(str(tmp_path / f"nbody-{n_bodies}" / f"traj_{n_sims}.npy"),
                            n_bodies=n_bodies, **cache)
    kw = dict(n_bodies=n_bodies, input_steps=cond_steps, output_steps=24, time_interval=4)
    return (JaxDataset(JaxConfig(**kw), n_sims=n_sims, cache_path=path),
            NBodyDataset(NBodyDatasetConfig(**kw), n_sims=n_sims, cache_path=path))


@pytest.mark.parametrize("cond_steps", [0, 1, 3])
def test_windows_and_batches_match_jax(tmp_path, cond_steps):
    jd, td = _pair(tmp_path, cond_steps)
    assert len(td) == len(jd) and td.time_stamps_effective == jd.time_stamps_effective
    idx = np.random.default_rng(1).integers(0, len(jd), 37)
    for i in idx[:5]:
        for a, b in zip(td.get_window(i), jd.get_window(i)):
            np.testing.assert_array_equal(a, b)
    want, got = jd.get_batch(idx), td.get_batch(idx)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_bodies,n_steps", [(2, 800), (3, 800), (2, 780)],
                         ids=["2-body", "3-body", "span-past-last-frame"])
def test_collision_mask_matches_the_per_window_loop(tmp_path, n_bodies, n_steps):
    """The vectorised mask against the JAX package's loop over windows,
    including windows whose span runs past the last simulated frame."""
    jd, td = _pair(tmp_path, n_bodies=n_bodies, n_steps=n_steps, n_sims=3)
    for thr in (60.0, 20.0):
        want = jd.collision_window_mask(thr)
        assert 0 < want.sum() < len(want)
        np.testing.assert_array_equal(td.collision_window_mask(thr), want)


@pytest.mark.parametrize("frac", [0.0, 0.3])
def test_iterate_batches_gives_the_same_stream(tmp_path, frac):
    jd, td = _pair(tmp_path)
    jit = jd.iterate_batches(8, seed=3, collision_frac=frac)
    tit = td.iterate_batches(8, seed=3, collision_frac=frac)
    # 70 batches of 8 cross the end of the first 525-window permutation
    for want, got in itertools.islice(zip(jit, tit), 70):
        np.testing.assert_array_equal(got["x"], want["x"])


def test_generated_cache_is_written_once_and_read_back(tmp_path):
    cfg = NBodyDatasetConfig(n_steps=120, time_stamps=110)
    path = str(tmp_path / "nbody-2" / "traj_3.npy")
    a = NBodyDataset(cfg, n_sims=3, seed=5, cache_path=path)
    assert a.data.shape == (3, 120, 2, 4) and np.isfinite(a.data).all()
    b = NBodyDataset(cfg, n_sims=3, seed=99, cache_path=path)  # read, not regenerated
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(np.load(path), a.data)


def test_generate_trajectories_is_seeded_and_chunk_independent_in_shape():
    run = lambda seed, chunk: generate_trajectories(
        torch.Generator().manual_seed(seed), 5, 2, n_steps=30, chunk=chunk)
    a, b = run(1, 8), run(1, 8)
    np.testing.assert_array_equal(a, b)
    assert a.shape == run(1, 2).shape == (5, 30, 2, 4)
    assert not np.array_equal(a, run(2, 8))
    # bodies stay in the 200 x 200 box
    assert (a[..., :2] >= 20 - 1e-3).all() and (a[..., :2] <= 180 + 1e-3).all()
