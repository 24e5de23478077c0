"""Batched elastic-ball simulator, the n-body ground-truth oracle.

Port of ``cindm_tpu/physics/nbody.py``: N rigid discs (radius 20, mass 1,
elasticity 1, no gravity) in a 200x200 box, stepped at dt = 1/60, the whole
batch at once. The JAX package's ``vmap`` over systems is the leading batch
dimension here, its ``scan`` over time a Python loop.

- ball-ball: overlapping and approaching pairs exchange their normal
  velocity components (equal masses, e = 1), and overlaps are pushed apart
  equally along the normal;
- ball-wall: the wall-normal velocity flips when a ball is past the wall
  and moving outward, and the position is clamped into the box.
"""

from __future__ import annotations

import torch

WIDTH = 200.0
HEIGHT = 200.0
RADIUS = 20.0
DT = 1.0 / 60.0


def _resolve_walls(pos, vel, radius: float, width: float, height: float):
    lo = torch.tensor([radius, radius], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([width - radius, height - radius], dtype=pos.dtype, device=pos.device)
    below = pos < lo
    above = pos > hi
    flip = (below & (vel < 0)) | (above & (vel > 0))
    vel = torch.where(flip, -vel, vel)
    pos = torch.minimum(torch.maximum(pos, lo), hi)
    return pos, vel


def _resolve_pairs(pos, vel, radius: float):
    """One pass of pairwise elastic collision resolution. pos/vel: [B, n, 2]."""
    n = pos.shape[1]
    if n < 2:
        return pos, vel
    dp = pos[:, :, None, :] - pos[:, None, :, :]  # [B, n, n, 2], i - j
    dist = torch.sqrt((dp * dp).sum(dim=-1) + 1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    overlapping = (dist < 2 * radius) & ~eye
    normal = dp / dist[..., None]  # from j to i
    dv = vel[:, :, None, :] - vel[:, None, :, :]  # v_i - v_j
    vn = (dv * normal).sum(dim=-1)  # [B, n, n]
    colliding = overlapping & (vn < 0.0)
    impulse = torch.where(colliding, vn, torch.zeros_like(vn))[..., None] * normal
    vel = vel - impulse.sum(dim=2)
    pen = torch.where(overlapping, 2 * radius - dist, torch.zeros_like(dist))
    pos = pos + (0.5 * pen[..., None] * normal).sum(dim=2)
    return pos, vel


def simulate(
    state0: torch.Tensor,
    n_steps: int,
    radius: float = RADIUS,
    width: float = WIDTH,
    height: float = HEIGHT,
    dt: float = DT,
) -> torch.Tensor:
    """Roll out a batch of n-body systems.

    state0: [B, n, 4] (x, y, vx, vy) in box units (0..200). Returns the
    [B, n_steps, n, 4] trajectory; step i records the state before
    integration step i.
    """
    pos, vel = state0[..., :2], state0[..., 2:]
    traj = []
    for _ in range(n_steps):
        traj.append(torch.cat([pos, vel], dim=-1))
        pos = pos + vel * dt
        pos, vel = _resolve_pairs(pos, vel, radius)
        pos, vel = _resolve_walls(pos, vel, radius, width, height)
    return torch.stack(traj, dim=1)


def eval_simu(
    cond_design: torch.Tensor,
    design_fn,
    n_bodies: int,
    rollout_steps: int,
    time_interval: int = 4,
):
    """Re-simulation scoring of a designed state.

    cond_design: [B, steps, n_bodies*4] normalized (/200) trajectory; its
    last step is the designed initial state. Returns (pred_simu
    [B, rollout_steps, n_bodies*4] normalized, design_fn(pred_simu)).
    """
    state = cond_design[:, -1, :] * 200.0
    state = state.reshape(state.shape[0], n_bodies, 4)
    traj = simulate(state, rollout_steps * time_interval)
    traj = traj.reshape(traj.shape[0], traj.shape[1], -1)
    traj = traj[:, time_interval - 1 :: time_interval] / 200.0
    return traj, design_fn(traj)


def generate_initial_states(
    generator: torch.Generator,
    n_sims: int,
    n_bodies: int,
    v_max: float = 100.0,
    radius: float = RADIUS,
    width: float = WIDTH,
    height: float = HEIGHT,
    n_resample: int = 200,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Random non-overlapping initial states [n_sims, n_bodies, 4].

    Positions uniform in [r, w-r], velocities uniform in [-v_max, v_max].
    A body that overlaps a lower-indexed body is redrawn, up to
    ``n_resample`` rounds (sequential rejection sampling). Draws come from
    ``generator``, which must live on ``device``.
    """
    lo = torch.tensor([radius, radius], device=device)
    hi = torch.tensor([width - radius, height - radius], device=device)

    def sample_pos():
        u = torch.rand((n_sims, n_bodies, 2), generator=generator, device=device)
        return lo + u * (hi - lo)

    lower = torch.tril(torch.ones((n_bodies, n_bodies), dtype=torch.bool, device=device), -1)
    pos = sample_pos()
    vel = (torch.rand((n_sims, n_bodies, 2), generator=generator, device=device) * 2 - 1) * v_max
    for _ in range(n_resample):
        d = torch.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)
        bad = ((d < 2 * radius) & lower).any(dim=-1)
        if not bool(bad.any()):
            break
        pos = torch.where(bad[..., None], sample_pos(), pos)
    return torch.cat([pos, vel], dim=-1)
