"""Airfoil (naca_ellipse) dataset: BDIM-generated flows and their windows.

Port of ``cindm_tpu/data/airfoil.py``. Trajectories come from the port's
batched BDIM solver (``physics.bdim.simulate_flow_batch``), on the device
the caller names; the windowing and normalization are numpy, as in the JAX
package:

- fields are 62 x 62 crops [row = y, col = x] of (vx, vy, p): the solver's
  [i = x, j = y] interiors transposed, cells 0..61 kept;
- global min-max normalization of each channel to [-1, 1], NaN -> 0;
- boundary polygon (40 points, grid units) normalized by /62 to [-1, 1];
- boundary mask = cells containing polygon points; boundary offset =
  point - (cell + 0.5), averaged per cell;
- windows: cond frames at ``time_interval`` before t, pred frames after.

Batch layout of the 2D diffusion trainer: x_start = [pred_frames*3 | mask |
offx | offy] and cond = [cond_frames*3], both padded 62 -> 64 and
channel-last [B, 64, 64, C], as the JAX package's batches.

Boundaries are drawn from ``np.random.default_rng(seed)`` in the JAX
package's order, so one seed gives the same boundaries in both packages;
the simulation cache (``<cache_dir>/{fields,boundary,mask,offset,forces}.npy``)
and the device sampler's prep cache (``flatrows_v1.npy``) have the JAX
package's layout, so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from ..physics.bdim import BDIMConfig, ellipse_coords, naca_coords, rotate_coords, simulate_flow_batch

CACHE_KEYS = ("fields", "boundary", "mask", "offset", "forces")
# designs a batched solve of ``generate_airfoil_sims`` (the JAX package takes
# 16); the chunk does not change the result (a batched solve equals the
# designs solved alone to 1e-6), only the launches per simulated design
SIM_CHUNK = 64


@dataclasses.dataclass
class AirfoilDatasetConfig:
    input_steps: int = 2  # cond_frames
    output_steps: int = 4  # pred_frames
    time_interval: int = 4
    time_stamps: int = 100  # recorded frames per simulation
    n_warmup: int = 300  # LilyPad records from t = 300
    grid: int = 64
    crop: int = 62
    # placement band (fractions of the grid)
    x_band: tuple = (0.25, 0.45)
    y_band: tuple = (0.4, 0.6)


def sample_boundary_params(rng: np.random.Generator, grid: int = 64,
                           x_band: tuple = (0.25, 0.45), y_band: tuple = (0.4, 0.6)) -> dict:
    """Random ellipse or NACA geometry: (x, y, size, aspect or thickness, angle)."""
    kind = int(rng.integers(0, 2))
    x = float(rng.uniform(grid * x_band[0], grid * x_band[1]))
    y = float(rng.uniform(grid * y_band[0], grid * y_band[1]))
    angle = float(rng.uniform(-0.4, 0.4))
    if kind == 0:
        h = float(rng.uniform(grid * 0.12, grid * 0.25))
        aspect = float(rng.uniform(1.0, 3.0))
        return dict(kind="ellipse", x=x, y=y, h=h, aspect=aspect, angle=angle)
    c = float(rng.uniform(grid * 0.2, grid * 0.35))
    t = float(rng.uniform(0.08, 0.2))
    return dict(kind="naca", x=x, y=y, c=c, t=t, angle=angle)


def boundary_coords(params: dict) -> np.ndarray:
    """40-point polygon in grid units from sampled params."""
    if params["kind"] == "ellipse":
        c = ellipse_coords(params["x"], params["y"], params["h"], params["aspect"], m=40)
    else:
        c = naca_coords(params["x"], params["y"], params["c"], params["t"], m=20)
    return rotate_coords(c, (params["x"], params["y"]), params["angle"])


def boundary_mask_offset(coords: np.ndarray, crop: int = 62) -> tuple[np.ndarray, np.ndarray]:
    """Rasterize polygon points to (mask [crop, crop], offset [crop, crop, 2]),
    indexed [row=y, col=x]; offset = point - (cell + 0.5), averaged per cell."""
    mask = np.zeros((crop, crop), np.float32)
    offset = np.zeros((crop, crop, 2), np.float32)
    counts = np.zeros((crop, crop), np.float32)
    x = np.clip(coords[:, 0], 0.5, crop + 0.5)
    y = np.clip(coords[:, 1], 0.5, crop + 0.5)
    xi = np.minimum(x.astype(np.int32), crop - 1)
    yi = np.minimum(y.astype(np.int32), crop - 1)
    for k in range(len(coords)):
        mask[yi[k], xi[k]] = 1.0
        offset[yi[k], xi[k], 0] += x[k] - (xi[k] + 0.5)
        offset[yi[k], xi[k], 1] += y[k] - (yi[k] + 0.5)
        counts[yi[k], xi[k]] += 1.0
    nz = counts > 0
    offset[nz] /= counts[nz][:, None]
    return mask, offset


def draw_boundaries(rng: np.random.Generator, n: int, cfg: AirfoilDatasetConfig) -> np.ndarray:
    """``n`` random boundaries from ``rng`` in the JAX package's draw order:
    [n, 40, 2] float32 polygons in grid units."""
    return np.stack([
        boundary_coords(sample_boundary_params(rng, cfg.grid, x_band=cfg.x_band, y_band=cfg.y_band))
        for _ in range(n)
    ]).astype(np.float32)


def generate_airfoil_sims(
    seed: int,
    n_sims: int,
    cfg: Optional[AirfoilDatasetConfig] = None,
    bdim_cfg: Optional[BDIMConfig] = None,
    cache_dir: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Run BDIM for ``n_sims`` random boundaries on ``device``, ``SIM_CHUNK``
    of them in one batched solve; returns numpy arrays: fields
    [S, T, 62, 62, 3] (vx, vy, p, [row=y, col=x]), boundary [S, 40, 2], mask
    [S, 62, 62], offset [S, 62, 62, 2], forces [S, T, 1, 2].

    ``cache_dir`` is read when it holds ``fields.npy`` and written otherwise.
    """
    cfg = cfg or AirfoilDatasetConfig()
    bdim_cfg = bdim_cfg or BDIMConfig(n=cfg.grid)
    if cache_dir is not None and os.path.exists(os.path.join(cache_dir, "fields.npy")):
        return {k: np.load(os.path.join(cache_dir, f"{k}.npy")) for k in CACHE_KEYS}
    rng = np.random.default_rng(seed)
    fields, bounds, masks, offs, forces = [], [], [], [], []
    c = cfg.crop
    for s0 in range(0, n_sims, SIM_CHUNK):
        bsz = min(SIM_CHUNK, n_sims - s0)
        coords_b = draw_boundaries(rng, bsz, cfg)
        (us, vs, ps), fs = simulate_flow_batch(bdim_cfg, coords_b, cfg.n_warmup, cfg.time_stamps,
                                               device=device)
        # solver arrays are [D, T, i=x, j=y]; datasets store [row=y, col=x]
        f = torch.stack([a.transpose(2, 3)[:, :, :c, :c] for a in (us, vs, ps)], dim=-1)
        fields.append(f.cpu().numpy())
        forces.append(fs.cpu().numpy())
        for k in range(bsz):
            m, o = boundary_mask_offset(coords_b[k], c)
            bounds.append(coords_b[k])
            masks.append(m)
            offs.append(o)
    out = {
        "fields": np.concatenate(fields),
        "boundary": np.stack(bounds),
        "mask": np.stack(masks),
        "offset": np.stack(offs),
        "forces": np.concatenate(forces),
    }
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        for k, v in out.items():
            np.save(os.path.join(cache_dir, f"{k}.npy"), v)
    return out


def load_reference_airfoil_dirs(root: str, dirname: str = "training_trajectories",
                                n_sims: int = 10, time_stamps: int = 100) -> dict:
    """Read a reference-layout airfoil dataset from disk:
    ``sim_{k:06d}/velocity_{t:06d}.npy`` [2, 62, 62],
    ``sim_{k:06d}/pressure_{t:06d}.npy`` [62, 62],
    ``sim_{k:06d}/boundary.npy`` [2, 40],
    ``boundary_mask/sim_{k:06d}.npy``, ``boundary_offset/sim_{k:06d}.npy``.
    Returns the layout of ``generate_airfoil_sims`` (forces zero)."""
    base = os.path.join(root, dirname)
    fields, bounds, masks, offs = [], [], [], []
    for k in range(n_sims):
        sim = os.path.join(base, f"sim_{k:06d}")
        frames = []
        for t in range(time_stamps):
            v = np.load(os.path.join(sim, f"velocity_{t:06d}.npy"))  # [2, 62, 62]
            p = np.load(os.path.join(sim, f"pressure_{t:06d}.npy"))  # [62, 62]
            frames.append(np.stack([v[0], v[1], p], axis=-1))
        fields.append(np.stack(frames))
        bounds.append(np.load(os.path.join(sim, "boundary.npy")).T)  # [40, 2]
        masks.append(np.load(os.path.join(base, "boundary_mask", f"sim_{k:06d}.npy")).reshape(62, 62))
        offs.append(np.load(os.path.join(base, "boundary_offset", f"sim_{k:06d}.npy"))
                    .reshape(62, 62, 2))
    return {
        "fields": np.stack(fields).astype(np.float32),
        "boundary": np.stack(bounds).astype(np.float32),
        "mask": np.stack(masks).astype(np.float32),
        "offset": np.stack(offs).astype(np.float32),
        "forces": np.zeros((n_sims, time_stamps, 1, 2), np.float32),
    }


class AirfoilDataset:
    """Windowed airfoil dataset with the reference normalization."""

    def __init__(self, data: dict, cfg: Optional[AirfoilDatasetConfig] = None):
        self.cfg = cfg or AirfoilDatasetConfig()
        self.data = data
        c = self.cfg
        self.t_cushion_input = max(c.input_steps * c.time_interval, 1)
        self.t_cushion_output = max(c.output_steps * c.time_interval, 1)
        self.time_stamps_effective = (
            c.time_stamps - self.t_cushion_input - self.t_cushion_output
        ) // c.time_interval
        f = data["fields"]
        self.n_simu = f.shape[0]
        # global min-max per channel
        self.x_min, self.x_max = float(f[..., 0].min()), float(f[..., 0].max())
        self.y_min, self.y_max = float(f[..., 1].min()), float(f[..., 1].max())
        self.p_min, self.p_max = float(f[..., 2].min()), float(f[..., 2].max())

    def __len__(self) -> int:
        return self.time_stamps_effective * self.n_simu

    def _norm(self, frames: np.ndarray) -> np.ndarray:
        lo = np.array([self.x_min, self.y_min, self.p_min], np.float32)
        hi = np.array([self.x_max, self.y_max, self.p_max], np.float32)
        out = (np.clip((frames - lo) / (hi - lo), 0, 1) - 0.5) * 2
        return np.nan_to_num(out, nan=0.0)

    def get_window(self, idx: int) -> dict:
        c = self.cfg
        sim_id, time_id = divmod(idx, self.time_stamps_effective)
        mid = time_id * c.time_interval + self.t_cushion_input
        f = self.data["fields"][sim_id]
        x = np.stack([f[mid + j] for j in range(-c.input_steps * c.time_interval, 0, c.time_interval)])
        y = np.stack([f[mid + j] for j in range(0, c.output_steps * c.time_interval, c.time_interval)])
        return {
            "x": self._norm(x),  # [cond_frames, 62, 62, 3]
            "y": self._norm(y),  # [pred_frames, 62, 62, 3]
            "mask": self.data["mask"][sim_id],
            "offset": self.data["offset"][sim_id],
            "boundary": (np.clip(self.data["boundary"][sim_id] / 62.0, 0, 1) - 0.5) * 2,
            "sim_id": sim_id,
        }

    def get_batch(self, indices: np.ndarray) -> dict:
        """Diffusion-ready batch: pads 62 -> 64, packs x_start = [pred*3 |
        mask | off] and cond = [cond*3], channel-last [B, 64, 64, C]."""
        xs, ys = [], []
        for i in indices:
            w = self.get_window(int(i))
            cond = np.concatenate(list(w["x"]), axis=-1)  # [62, 62, T*3]
            pred = np.concatenate(list(w["y"]), axis=-1)
            aux = np.concatenate([w["mask"][..., None], w["offset"]], axis=-1)
            pad = ((0, 2), (0, 2), (0, 0))
            xs.append(np.pad(np.concatenate([pred, aux], axis=-1), pad))
            ys.append(np.pad(cond, pad))
        return {"x": np.stack(xs).astype(np.float32), "cond": np.stack(ys).astype(np.float32)}

    def iterate_batches(self, batch_size: int, seed: int = 0, loop: bool = True) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield self.get_batch(perm[i: i + batch_size])
            if not loop:
                return

    def make_device_sampler(self, batch_size: int, device: str | torch.device = "cuda",
                            prep_cache: Optional[str] = None):
        """The normalized, padded frames on ``device`` once, and
        ``draw(arrays, generator) -> {'x', 'cond'}`` gathering a random batch
        there (no host transfer a step). The batch layout is ``get_batch``'s.

        Frames are flat rows [S*T, 64*64*3] and the aux channels (mask,
        offset) rows [S, 64*64*3]: a batch gathers rows by flat index. The
        prepared rows are cached in ``prep_cache`` (the JAX package's
        ``flatrows_v1.npy`` layout). ``draw.gather(arrays, sim, mid)`` is the
        deterministic path; ``draw.arrays`` holds the tensors. ``draw``
        takes sim ~ U[0, S) and then the window ~ U[0, windows per
        simulation) from ``generator`` (the JAX package splits a key into
        the same two draws)."""
        c = self.cfg
        f = self.data["fields"]  # [S, T, 62, 62, 3]
        S, T = f.shape[0], f.shape[1]
        if prep_cache is not None and os.path.exists(prep_cache):
            rows = np.load(prep_cache, mmap_mode="r")
            if rows.shape != (S * T, 64 * 64 * 3):
                raise ValueError(f"{prep_cache}: rows {rows.shape}, expected {(S * T, 64 * 64 * 3)}")
        else:
            pad4 = ((0, 0), (0, 0), (0, 2), (0, 2), (0, 0))
            rows = np.pad(self._norm(f), pad4).reshape(S * T, 64 * 64 * 3)
            if prep_cache is not None:
                np.save(prep_cache + ".tmp.npy", rows)
                os.replace(prep_cache + ".tmp.npy", prep_cache)
        aux = np.concatenate([self.data["mask"][..., None], self.data["offset"]], axis=-1)
        aux = np.pad(aux, ((0, 0), (0, 2), (0, 2), (0, 0))).reshape(S, 64 * 64 * 3)
        arrays = {"fields": torch.tensor(np.asarray(rows), dtype=torch.float32,
                                            device=device),
                  "aux": torch.as_tensor(aux, dtype=torch.float32, device=device)}
        cond_off = torch.arange(-c.input_steps * c.time_interval, 0, c.time_interval, device=device)
        pred_off = torch.arange(0, c.output_steps * c.time_interval, c.time_interval, device=device)
        eff, cushion, B = self.time_stamps_effective, self.t_cushion_input, batch_size

        def gather(arrays: dict, sim: torch.Tensor, mid: torch.Tensor) -> dict:
            n = len(sim)

            def pack(offsets):
                idx = sim[:, None] * T + mid[:, None] + offsets[None, :]  # [B, nf]
                g = arrays["fields"][idx].reshape(n, -1, 64, 64, 3)
                return g.permute(0, 2, 3, 1, 4).reshape(n, 64, 64, -1)  # frame-major channels

            a = arrays["aux"][sim].reshape(n, 64, 64, 3)
            return {"x": torch.cat([pack(pred_off), a], dim=-1), "cond": pack(cond_off)}

        def draw(arrays: dict, generator: torch.Generator) -> dict:
            dev = arrays["fields"].device
            sim = torch.randint(0, S, (B,), generator=generator, device=dev)
            mid = torch.randint(0, eff, (B,), generator=generator, device=dev) * c.time_interval + cushion
            return gather(arrays, sim, mid)

        draw.arrays = arrays
        draw.gather = gather
        return draw
