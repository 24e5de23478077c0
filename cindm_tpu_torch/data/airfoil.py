"""Airfoil geometry helpers (numpy).

Port of the geometry half of ``cindm_tpu/data/airfoil.py``: the dataset
configuration, random ellipse/NACA boundary parameters, their 40-point
polygons (grid units) and the rasterized boundary mask and offset that the
2D prior's last three channels hold. The simulation generator and the
dataset (``generate_airfoil_sims``, ``AirfoilDataset``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.bdim import ellipse_coords, naca_coords, rotate_coords


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
