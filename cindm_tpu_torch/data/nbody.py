"""N-body trajectory dataset: generation on the device and windowing on the host.

Port of ``cindm_tpu/data/nbody.py``. Trajectories come from the port's
batched simulator (``physics.nbody``), run on the device the caller names;
windows are cut with numpy into [B, steps, n_bodies*4] batches normalized
by /200. The cache file (``traj_{n_sims}.npy``), the windowing arithmetic and
the batch sampler are those of the JAX package, so both packages read one
cache into identical batches.

Windowing: ``time_stamps`` = 800 frames per simulation, cushions of
input/output steps times ``time_interval``; window i of a simulation starts
at frame ``i * time_interval + cushion_in`` and takes every
``time_interval``-th frame.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..physics.nbody import generate_initial_states, simulate


@dataclasses.dataclass
class NBodyDatasetConfig:
    n_bodies: int = 2
    input_steps: int = 0  # conditioned_steps
    output_steps: int = 24  # rollout_steps
    time_interval: int = 4
    time_stamps: int = 800  # frames used per simulation
    n_steps: int = 1000  # frames simulated per trajectory
    v_max: float = 100.0


def generate_trajectories(
    generator: torch.Generator,
    n_sims: int,
    n_bodies: int,
    n_steps: int = 1000,
    v_max: float = 100.0,
    chunk: int = 8192,
    device: str | torch.device = "cpu",
) -> np.ndarray:
    """Simulate [n_sims, n_steps, n_bodies, 4] on ``device`` (where
    ``generator`` lives), ``chunk`` systems at a time, as a float32 numpy array."""
    out = []
    for i in range(0, n_sims, chunk):
        b = min(chunk, n_sims - i)
        state0 = generate_initial_states(generator, b, n_bodies, v_max=v_max, device=device)
        out.append(simulate(state0, n_steps).cpu().numpy())
    return np.concatenate(out, axis=0)


class NBodyDataset:
    """Windowed trajectory dataset with the reference's index arithmetic.

    Without ``data``, reads ``cache_path`` if it exists, or else simulates
    ``n_sims`` trajectories on ``device`` from a generator seeded with
    ``seed`` and writes them to ``cache_path``.
    """

    def __init__(
        self,
        cfg: NBodyDatasetConfig,
        data: Optional[np.ndarray] = None,
        n_sims: int = 200,
        seed: int = 0,
        cache_path: Optional[str] = None,
        device: str | torch.device = "cpu",
    ):
        self.cfg = cfg
        if data is None:
            if cache_path is not None and os.path.exists(cache_path):
                data = np.load(cache_path)
            else:
                generator = torch.Generator(device=device).manual_seed(seed)
                data = generate_trajectories(
                    generator, n_sims, cfg.n_bodies, cfg.n_steps, cfg.v_max, device=device
                )
                if cache_path is not None:
                    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                    np.save(cache_path, data)
        self.data = data.astype(np.float32)  # [n_sims, n_steps, n, 4]
        c = cfg
        self.t_cushion_input = max(c.input_steps * c.time_interval, 1)
        self.t_cushion_output = max(c.output_steps * c.time_interval, 1)
        self.time_stamps_effective = (
            c.time_stamps - self.t_cushion_input - self.t_cushion_output
        ) // c.time_interval
        self.n_simu = self.data.shape[0]

    def __len__(self) -> int:
        return self.time_stamps_effective * self.n_simu

    def _start(self, idx):
        """(simulation, first output frame) of window(s) ``idx``."""
        sim_id, time_id = np.divmod(idx, self.time_stamps_effective)
        return sim_id, time_id * self.cfg.time_interval + self.t_cushion_input

    def get_window(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (x [input_steps, n, 4], y [output_steps, n, 4]), raw units."""
        c = self.cfg
        sim_id, mid = self._start(int(idx))
        x = self.data[sim_id, mid - c.input_steps * c.time_interval : mid : c.time_interval]
        y = self.data[sim_id, mid : mid + c.output_steps * c.time_interval : c.time_interval]
        return x, y

    def get_batch(self, indices: np.ndarray) -> dict:
        """Batched windows in diffusion layout: [B, steps, n*4] normalized /200.
        One gather for the whole batch; the same values as stacking
        ``get_window`` per index."""
        c = self.cfg
        sim_id, mid = self._start(np.asarray(indices, dtype=np.int64))
        itv = c.time_interval

        def frames(offsets):
            a = self.data[sim_id[:, None], mid[:, None] + offsets[None, :]]
            return (a.reshape(len(sim_id), -1, c.n_bodies * 4) / 200.0).astype(np.float32)

        batch = {"x": frames(np.arange(c.output_steps) * itv)}
        if c.input_steps > 0:
            batch["cond"] = frames(np.arange(-c.input_steps, 0) * itv)
        return batch

    def get_gns_batch(self, indices: np.ndarray, n_his: int = 4, noise_std: float = 0.0,
                      seed: int = 0) -> dict:
        """A GNS-format batch: position histories ``poss`` [B, n, n_his, 2]
        and targets ``tgt_poss`` [B, n, output_steps - n_his, 2], normalized
        by /200, with ``particle_type`` zeros [B, n]; with ``noise_std > 0``
        random-walk noise from a CPU generator seeded with ``seed`` is added
        to the history."""
        from ..utils.extras import random_walk_noise

        x = self.get_batch(indices)["x"]  # [B, T, n*4] / 200
        B, T, _ = x.shape
        pos = x.reshape(B, T, self.cfg.n_bodies, 4)[..., :2].transpose(0, 2, 1, 3)
        hist, tgt = pos[:, :, :n_his], pos[:, :, n_his:]
        if noise_std > 0:
            g = torch.Generator().manual_seed(seed)
            noise = random_walk_noise(g, (B * self.cfg.n_bodies, n_his, 2), noise_std)
            hist = hist + noise.numpy().reshape(hist.shape)
        return {"poss": np.ascontiguousarray(hist, np.float32),
                "tgt_poss": np.ascontiguousarray(tgt, np.float32),
                "particle_type": np.zeros(hist.shape[:2], np.int32)}

    def collision_window_mask(self, threshold: float = 60.0) -> np.ndarray:
        """Boolean [len(self)]: windows whose bodies come within ``threshold``
        px of each other (ball radius 20, so 60 px is a close encounter).

        The minimum pairwise distance over each window's output span, taken
        with a sliding window over the frames of one block of simulations at a
        time instead of one Python iteration per window; a span that runs past
        the last frame is cut there, as a slice would cut it."""
        c = self.cfg
        pos = self.data[..., :2]  # [S, T, n, 2]
        ii, jj = np.triu_indices(c.n_bodies, k=1)
        d = np.linalg.norm(pos[:, :, ii] - pos[:, :, jj], axis=-1)  # [S, T, P]
        dmin_t = d.min(axis=-1)  # [S, T]
        span = c.output_steps * c.time_interval
        mids = np.arange(self.time_stamps_effective) * c.time_interval + self.t_cushion_input
        padded = np.pad(dmin_t, ((0, 0), (0, span)), constant_values=np.inf)
        out = np.empty((self.n_simu, len(mids)), dtype=bool)
        for s in range(0, self.n_simu, 256):
            win = np.lib.stride_tricks.sliding_window_view(padded[s : s + 256], span, axis=1)
            out[s : s + 256] = win[:, mids].min(axis=-1) < threshold
        return out.reshape(-1)

    def iterate_batches(
        self, batch_size: int, seed: int = 0, loop: bool = True,
        collision_frac: float = 0.0, collision_threshold: float = 60.0,
    ) -> Iterator[dict]:
        """Deterministic shuffled sampler: numpy ``default_rng(seed)``
        permutations; with ``collision_frac > 0`` that fraction of every batch
        is drawn (with replacement) from collision-rich windows."""
        rng = np.random.default_rng(seed)
        n = len(self)
        coll_idx = None
        if collision_frac > 0.0:
            coll_idx = np.flatnonzero(self.collision_window_mask(collision_threshold))
            if len(coll_idx) == 0:
                coll_idx = None  # nothing qualifies; fall back to uniform
        k_coll = int(batch_size * collision_frac) if coll_idx is not None else 0
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = perm[i : i + batch_size]
                if k_coll:
                    extra = rng.choice(coll_idx, size=k_coll, replace=True)
                    idx = np.concatenate([idx[: batch_size - k_coll], extra])
                yield self.get_batch(idx)
            if not loop:
                return
