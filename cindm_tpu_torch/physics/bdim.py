"""BDIM immersed-boundary Navier-Stokes solver, batched over designs.

Port of ``cindm_tpu/physics/bdim.py`` (the LilyPad replacement that scores
airfoil designs). Where the JAX package runs one design under ``vmap``,
every field here is a tensor [D, N, N] over D designs, a[d, i, j] with i
the x index and j the y index (LilyPad's convention, the transpose of the
64 x 64 image layout). Every reduction that the JAX solver takes over one
design (the exit mass flux of ``set_bc_u``, the pressure mean of
``_update_up``, the inner products and guards of the CG solve, the CFL
maximum) reduces over the last two dims only, so designs never couple.
A step issues no host synchronisation; ``lax.scan`` / ``fori_loop`` are
Python loops under ``torch.no_grad()``.

Numerics, as in the JAX package (semi-Lagrangian branch, nu = 0, which
the airfoil evaluation runs; the QUICK + viscous branch beside it):

- staggered faces on an (n+2)^2 grid with ghost cells;
- BDIM u = delta0 F + (1 - delta0) u_b + delta1 d_n(F - u_b), static body;
- RK2 semi-Lagrangian advection with limited quadratic interpolation;
- Jacobi-preconditioned CG projection with a fixed iteration count and
  Neumann pressure edges;
- inlet u = u_inf, gradient exit with a mass-flux correction;
- pressure force = closed integral of p n dl over the polygon segments.

The geometry helpers ``ellipse_coords``, ``naca_coords`` and
``rotate_coords`` are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# geometry


def ellipse_coords(x: float, y: float, h: float, aspect: float, m: int = 40) -> np.ndarray:
    """EllipseBody polygon: h is the full height; semi-axes (0.5 h / aspect, 0.5 h)."""
    dx, dy = 0.5 * h / aspect, 0.5 * h
    theta = -2 * np.pi * np.arange(m) / m
    return np.stack([x + dx * np.cos(theta), y + dy * np.sin(theta)], -1)


def _naca_offset(x: np.ndarray) -> np.ndarray:
    return 5 * (
        0.2969 * np.sqrt(x) - 0.126 * x - 0.3516 * x**2 + 0.2843 * x**3 - 0.1015 * x**4
    )


def naca_coords(x: float, y: float, c: float, t: float, pivot: float = 0.25,
                m: int = 20) -> np.ndarray:
    """DiscNACA polygon: chord c, thickness ratio t."""
    pts = [(x - c * pivot, y)]
    for i in range(1, m):
        xx = (i / m) ** 2
        pts.append((x + c * (xx - pivot), y + t * c * float(_naca_offset(np.array(xx)))))
    pts.append((x + c * (1 - pivot), y))
    for i in range(m - 1, 0, -1):
        xx = (i / m) ** 2
        pts.append((x + c * (xx - pivot), y - t * c * float(_naca_offset(np.array(xx)))))
    return np.array(pts)


def rotate_coords(coords: np.ndarray, center, dphi: float) -> np.ndarray:
    """Body.rotate: turn the points by dphi about ``center``."""
    sa, ca = np.sin(dphi), np.cos(dphi)
    z = coords - np.asarray(center)
    return np.stack([ca * z[:, 0] - sa * z[:, 1], sa * z[:, 0] + ca * z[:, 1]], -1) + np.asarray(
        center
    )


def polygon_sdf(coords: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Signed distance to closed polygons, positive outside.

    coords [*P, M, 2]; qx, qy query grids of one shape [*Q]; returns
    [*P, *Q]. Zero-length segments (edge-padded polygons) are guarded as in
    the JAX package (1e-12 in the projection and the crossing test, 1e-20
    under the square root)."""
    P, Q = coords.shape[:-2], qx.shape
    a = coords.reshape(-1, 1, coords.shape[-2], 2)  # [P, 1, M, 2]
    b = torch.roll(a, -1, dims=2)
    q = torch.stack([qx.reshape(-1), qy.reshape(-1)], dim=-1)[None, :, None, :]  # [1, Q, 1, 2]
    pa = q - a
    ab = b - a
    t = ((pa * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-12)).clamp(0.0, 1.0)
    closest = a + t[..., None] * ab
    dist = torch.sqrt((q - closest).square().sum(-1) + 1e-20).amin(dim=-1)
    # even-odd crossing test for inside/outside
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    qxx, qyy = q[..., 0], q[..., 1]
    cond = (ay <= qyy) != (by <= qyy)
    denom = torch.where((by - ay).abs() < 1e-12, torch.full_like(ay, 1e-12), by - ay)
    xint = ax + (qyy - ay) / denom * (bx - ax)
    inside = (cond & (qxx < xint)).sum(-1) % 2 == 1
    return torch.where(inside, -dist, dist).reshape(*P, *Q)


def multi_polygon_sdf(coords: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """Union of polygons: coords [M, 2] is one polygon; [*B, K, M, 2] is
    the min over the K polygons, giving [*B, *Q]."""
    if coords.ndim == 2:
        return polygon_sdf(coords, qx, qy)
    return polygon_sdf(coords, qx, qy).amin(dim=coords.ndim - 3)


# ---------------------------------------------------------------------------
# BDIM kernel moments


def delta0(d: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + d + torch.sin(math.pi * d) / math.pi)


def delta1(d: torch.Tensor, eps: float) -> torch.Tensor:
    return eps * (
        0.25 * (1.0 - d * d)
        - 1.0 / (2 * math.pi) * (d * torch.sin(d * math.pi) + (1.0 / math.pi) * (1.0 + torch.cos(d * math.pi)))
    )


# ---------------------------------------------------------------------------
# field ops on [D, N, N] (ghost ring included, a[d, i, j] = (x=i, y=j))


def set_bc_u(a: torch.Tensor, u_inf: float) -> torch.Tensor:
    """Inlet fixed at u_inf, zero-gradient exit corrected to conserve the
    mass flux (per design), copied top/bottom. Writes into a copy, in the
    JAX package's order: the exit mean is taken after the ghost copies."""
    a = a.clone()
    a[:, 0, :] = a[:, 1, :]
    a[:, -1, :] = a[:, -2, :]
    a[:, 1, :] = u_inf
    s = a[:, -1, 1:-1].mean(dim=-1, keepdim=True)
    a[:, -1, 1:-1] += u_inf - s
    a[:, :, 0] = a[:, :, 1]
    a[:, :, -1] = a[:, :, -2]
    return a


def set_bc_v(a: torch.Tensor) -> torch.Tensor:
    """Solid top/bottom (v = 0), copied left/right."""
    a = a.clone()
    a[:, 0, :] = a[:, 1, :]
    a[:, -1, :] = a[:, -2, :]
    a[:, :, 1] = 0.0
    a[:, :, -1] = 0.0
    a[:, :, 0] = a[:, :, 1]
    return a


def set_bc_p(a: torch.Tensor) -> torch.Tensor:
    a = a.clone()
    a[:, 0, :] = a[:, 1, :]
    a[:, -1, :] = a[:, -2, :]
    a[:, :, 0] = a[:, :, 1]
    a[:, :, -1] = a[:, :, -2]
    return a


def _gather(a: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a[d, i, j] for index tensors [D, ...] of one shape."""
    D, _, M = a.shape
    return torch.gather(a.reshape(D, -1), 1, (i * M + j).reshape(D, -1)).reshape(i.shape)


def _bilinear(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Field.linear on array indices: a [D, N, M]; x, y [D, ...] already
    offset for the staggering (clipped to >= 0.5, so truncation is floor)."""
    _, N, M = a.shape
    x = x.clamp(0.5, N - 1.5)
    y = y.clamp(0.5, M - 1.5)
    i = x.long().clamp(max=N - 2)
    j = y.long().clamp(max=M - 2)
    s = x - i
    t = y - j
    return s * (t * _gather(a, i + 1, j + 1) + (1 - t) * _gather(a, i + 1, j)) + (1 - s) * (
        t * _gather(a, i, j + 1) + (1 - t) * _gather(a, i, j)
    )


def _quadratic1d(x, e, f, g):
    x2 = x * x
    fx = f * (1.0 - x2) + (g * (x2 + x) + e * (x2 - x)) * 0.5
    fx = torch.minimum(fx, torch.maximum(torch.maximum(e, f), g))
    fx = torch.maximum(fx, torch.minimum(torch.minimum(e, f), g))
    return fx


def _quadratic(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Limited quadratic interpolation, bilinear near the boundary ring."""
    _, N, M = a.shape
    i = torch.round(x).long()
    j = torch.round(y).long()
    ic = i.clamp(1, N - 2)
    jc = j.clamp(1, M - 2)
    fx = x - ic
    fy = y - jc
    row = lambda dj: _quadratic1d(fx, _gather(a, ic - 1, jc + dj), _gather(a, ic, jc + dj),
                                  _gather(a, ic + 1, jc + dj))
    q = _quadratic1d(fy, row(-1), row(0), row(1))
    out_of_range = (i > N - 2) | (i < 1) | (j > M - 2) | (j < 1)
    return torch.where(out_of_range, _bilinear(a, x, y), q)


def _face_grids(N: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(N, dtype=torch.float32, device=device)[:, None].expand(N, N)
    j = torch.arange(N, dtype=torch.float32, device=device)[None, :].expand(N, N)
    return i, j


def _stagger(a: torch.Tensor, btype: int):
    i, j = _face_grids(a.shape[-1], a.device)
    return i - (0.5 if btype == 1 else 0.0), j - (0.5 if btype == 2 else 0.0)


def advect_single(a: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor, dt: float,
                  btype: int) -> torch.Tensor:
    """First-step semi-Lagrangian advection."""
    x, y = _stagger(a, btype)
    ax = -dt * _bilinear(ux, (x + 0.5).expand_as(a), y.expand_as(a))
    ay = -dt * _bilinear(uy, x.expand_as(a), (y + 0.5).expand_as(a))
    xs = x + ax + (0.5 if btype == 1 else 0.0)
    ys = y + ay + (0.5 if btype == 2 else 0.0)
    return _quadratic(a, xs, ys)


def advect_double(a: torch.Tensor, ux, uy, u0x, u0y, dt: float, btype: int) -> torch.Tensor:
    """RK2 two-velocity advection."""
    x, y = _stagger(a, btype)
    ax = -dt * _bilinear(ux, (x + 0.5).expand_as(a), y.expand_as(a))
    ay = -dt * _bilinear(uy, x.expand_as(a), (y + 0.5).expand_as(a))
    bx = -dt * _bilinear(u0x, x + ax + 0.5, y + ay)
    by = -dt * _bilinear(u0y, x + ax, y + ay + 0.5)
    xs = x + 0.5 * (ax + bx) + (0.5 if btype == 1 else 0.0)
    ys = y + 0.5 * (ay + by) + (0.5 if btype == 2 else 0.0)
    return _quadratic(a, xs, ys)


# ---------------------------------------------------------------------------
# QUICK flux advection + explicit diffusion (the branch for finite-Re anchors)

_QUICK_CF = 1.0 / 6.0
_QUICK_S = 10.0


def _shift(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """a[i+di, j+dj] via roll (wrapped entries are masked by callers)."""
    return torch.roll(a, (-di, -dj), (-2, -1))


def _quick_face(b: torch.Tensor, d1: int, d2: int, uf: torch.Tensor) -> torch.Tensor:
    """Upwind-biased QUICK face value with the median limiter; central where
    too close to the wall."""
    N, M = b.shape[-2:]
    b_d = _shift(b, d1, d2)
    bf = 0.5 * (b + b_d)
    flip = (d1 + d2) * uf < 0
    C = torch.where(flip, b_d, b)
    D = torch.where(flip, b, b_d)
    U = torch.where(flip, _shift(b, 2 * d1, 2 * d2), _shift(b, -d1, -d2))
    ii = torch.arange(N, device=b.device)[:, None]
    jj = torch.arange(M, device=b.device)[None, :]
    bi = torch.where(flip, ii + d1, ii)
    bj = torch.where(flip, jj + d2, jj)
    ok = (bi >= 2) & (bi <= N - 2) & (bj >= 2) & (bj <= M - 2)
    bq = bf - _QUICK_CF * (D - 2.0 * C + U)
    b1 = U + _QUICK_S * (C - U)
    med = lambda x, y, z: torch.maximum(torch.minimum(x, y), torch.minimum(torch.maximum(x, y), z))
    return torch.where(ok, med(bq, C, med(C, D, b1)), bf)


def _advect_flux(b: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor, btype: int) -> torch.Tensor:
    """Flux-form advection -div(u b) on the staggered grid."""
    if btype == 1:
        uo = 0.5 * (_shift(ux, -1, 0) + ux)
        ue = 0.5 * (_shift(ux, 1, 0) + ux)
        vs = 0.5 * (uy + _shift(uy, -1, 0))
        vn = 0.5 * (_shift(uy, 0, 1) + _shift(uy, -1, 1))
    else:
        uo = 0.5 * (_shift(ux, 0, -1) + ux)
        ue = 0.5 * (_shift(ux, 1, -1) + _shift(ux, 1, 0))
        vs = 0.5 * (_shift(uy, 0, -1) + uy)
        vn = 0.5 * (uy + _shift(uy, 0, 1))
    return (
        uo * _quick_face(b, -1, 0, uo)
        - ue * _quick_face(b, 1, 0, ue)
        + vs * _quick_face(b, 0, -1, vs)
        - vn * _quick_face(b, 0, 1, vn)
    )


def _interior(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A zero field shaped like ``like`` with ``values`` in its interior."""
    out = torch.zeros_like(like)
    out[..., 1:-1, 1:-1] = values
    return out


def adv_dif(b: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor, nu: float, btype: int) -> torch.Tensor:
    """advection(b; u) + nu * laplacian(b) on interior cells."""
    adv = _advect_flux(b, ux, uy, btype)
    lap = _shift(b, 1, 0) + _shift(b, -1, 0) + _shift(b, 0, 1) + _shift(b, 0, -1) - 4.0 * b
    out = adv + nu * lap
    return _interior(out[..., 1:-1, 1:-1], b)


def cfl_dt(ux: torch.Tensor, uy: torch.Tensor, nu: float) -> torch.Tensor:
    """LilyPad's CFL limit dt = 1 / (max(|u| + |v|) + 3 nu), per design: [D]."""
    return 1.0 / ((ux.abs() + uy.abs()).amax(dim=(-2, -1)) + 3.0 * nu)


def divergence(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Interior divergence of the staggered field."""
    return _interior(ux[..., 2:, 1:-1] - ux[..., 1:-1, 1:-1] + uy[..., 1:-1, 2:] - uy[..., 1:-1, 1:-1], ux)


def gradient(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Field.gradient, interior only."""
    return (_interior(p[..., 1:-1, 1:-1] - p[..., :-2, 1:-1], p),
            _interior(p[..., 1:-1, 1:-1] - p[..., 1:-1, :-2], p))


def normal_grad(a: torch.Tensor, wnx: torch.Tensor, wny: torch.Tensor) -> torch.Tensor:
    """wn . grad(a) with central differences."""
    return _interior(0.5 * (wnx[..., 1:-1, 1:-1] * (a[..., 2:, 1:-1] - a[..., :-2, 1:-1])
                            + wny[..., 1:-1, 1:-1] * (a[..., 1:-1, 2:] - a[..., 1:-1, :-2])), a)


# ---------------------------------------------------------------------------
# Poisson projection


def poisson_matvec(cx: torch.Tensor, cy: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """5-point variable-coefficient Laplacian A p, interior only."""
    c = p[..., 1:-1, 1:-1]
    return _interior(
        cx[..., 1:-1, 1:-1] * (p[..., :-2, 1:-1] - c)
        + cx[..., 2:, 1:-1] * (p[..., 2:, 1:-1] - c)
        + cy[..., 1:-1, 1:-1] * (p[..., 1:-1, :-2] - c)
        + cy[..., 1:-1, 2:] * (p[..., 1:-1, 2:] - c),
        p,
    )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-design inner product: [D, N, N] x2 -> [D, 1, 1]."""
    return (a * b).sum(dim=(-2, -1), keepdim=True)


def _guard(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)


def poisson_solve_cg(cx: torch.Tensor, cy: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                     iters: int = 60) -> torch.Tensor:
    """Jacobi-preconditioned CG with a fixed iteration count, each design
    solved on its own (per-design inner products, guards elementwise)."""
    diag = _interior(-(cx[..., 1:-1, 1:-1] + cx[..., 2:, 1:-1] + cy[..., 1:-1, 1:-1]
                       + cy[..., 1:-1, 2:]), b)
    inv = torch.where(diag.abs() > 1e-5,
                      -1.0 / torch.where(diag == 0, torch.ones_like(diag), diag),
                      torch.ones_like(diag))
    # solve (-A) x = (-b): -A is SPD on the interior (modulo constants)
    interior = _interior(torch.ones_like(b[..., 1:-1, 1:-1]), b)

    def amul(x):
        return -poisson_matvec(cx, cy, x) * interior

    x = x0 * interior
    r = -b * interior - amul(x)
    z = inv * r * interior
    rho = _dot(r, z)
    pvec = z
    for _ in range(iters):
        ap = amul(pvec)
        alpha = rho / _guard(_dot(pvec, ap))
        x = x + alpha * pvec
        r = r - alpha * ap
        z = inv * r * interior
        rho_new = _dot(r, z)
        beta = rho_new / _guard(rho)
        pvec = z + beta * pvec
        rho = rho_new
    return x


# ---------------------------------------------------------------------------
# solver


class BDIMConsts(NamedTuple):
    """Static-body coefficients of each design, [D, N, N] each."""

    del_x: torch.Tensor  # delta0 at u faces
    del_y: torch.Tensor
    del1_x: torch.Tensor  # delta1 at u faces
    del1_y: torch.Tensor
    wnx_x: torch.Tensor  # wall normal at u faces
    wny_x: torch.Tensor
    wnx_y: torch.Tensor  # wall normal at v faces
    wny_y: torch.Tensor


class BDIMState(NamedTuple):
    u: torch.Tensor  # [D, N, N] x-velocity at x-faces
    v: torch.Tensor
    p: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BDIMConfig:
    n: int = 64  # interior cells (grid is (n+2)^2)
    dt: float = 1.0
    u_inf: float = 1.0
    eps: float = 2.0  # kernel half-width
    cg_iters: int = 60
    nu: float = 0.0  # kinematic viscosity; only used by the QUICK branch
    quick: bool = False  # QUICK flux advection + explicit nu

    @property
    def N(self) -> int:
        return self.n + 2


def make_consts(cfg: BDIMConfig, coords: torch.Tensor) -> BDIMConsts:
    """delta0 / delta1 / wall normals at the faces of each design.
    coords: [D, K, M, 2] polygons in grid units (K bodies a design)."""
    i, j = _face_grids(cfg.N, coords.device)
    sdf = lambda qx, qy: multi_polygon_sdf(coords, qx, qy)

    def face_coeffs(qx, qy):
        dist = sdf(qx, qy)
        d = (dist / cfg.eps).clamp(-1.0, 1.0)
        # wall normal = normalized finite-difference gradient of the sdf
        h = 0.5
        gx = (sdf(qx + h, qy) - sdf(qx - h, qy)) / (2 * h)
        gy = (sdf(qx, qy + h) - sdf(qx, qy - h)) / (2 * h)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        # a zero normal far from the body
        near = dist.abs() < 3.0
        zero = torch.zeros_like(dist)
        return (delta0(d), delta1(d, cfg.eps), torch.where(near, gx / mag, zero),
                torch.where(near, gy / mag, zero))

    d0x, d1x, wnxx, wnyx = face_coeffs(i - 0.5, j)
    d0y, d1y, wnxy, wnyy = face_coeffs(i, j - 0.5)
    return BDIMConsts(set_bc_p(d0x), set_bc_p(d0y), set_bc_p(d1x), set_bc_p(d1y),
                      wnxx, wnyx, wnxy, wnyy)


def init_state(cfg: BDIMConfig, designs: int = 1, device: str | torch.device = "cuda") -> BDIMState:
    from ..utils.device import resolve_device  # here: utils imports this module

    N, device = cfg.N, resolve_device(device)
    u = set_bc_u(torch.full((designs, N, N), cfg.u_inf, device=device), cfg.u_inf)
    v = set_bc_v(torch.zeros((designs, N, N), device=device))
    return BDIMState(u, v, torch.zeros((designs, N, N), device=device))


def _update_up(cfg: BDIMConfig, consts: BDIMConsts, Rx, Ry, cx, cy, dux, duy, p):
    """BDIM forcing + projection, static body (u_b = 0). The boundary-face
    link coefficients are cut (Neumann pressure edges)."""
    cx = cx.clone()
    cx[:, 1, :] = 0.0
    cx[:, -1, :] = 0.0
    cy = cy.clone()
    cy[:, :, 1] = 0.0
    cy[:, :, -1] = 0.0
    u = consts.del_x * Rx
    v = consts.del_y * Ry
    u = u + consts.del1_x * normal_grad(dux, consts.wnx_x, consts.wny_x)
    v = v + consts.del1_y * normal_grad(duy, consts.wnx_y, consts.wny_y)
    u = set_bc_u(u, cfg.u_inf)
    v = set_bc_v(v)
    # project: solve div(c grad p) = div(u), subtract the mean, correct u
    s = divergence(u, v)
    p = poisson_solve_cg(cx, cy, s, p, cfg.cg_iters)
    p = p - p[:, 1:-1, 1:-1].mean(dim=(-2, -1), keepdim=True)
    gx, gy = gradient(p)
    u = set_bc_u(u - cx * gx, cfg.u_inf)
    v = set_bc_v(v - cy * gy)
    return u, v, p


def bdim_step_quick(cfg: BDIMConfig, consts: BDIMConsts, state: BDIMState) -> BDIMState:
    """One predictor + corrector step of the QUICK branch (Heun-averaged)."""
    dt, nu = cfg.dt, cfg.nu
    cx = consts.del_x * dt
    cy = consts.del_y * dt
    u0x, u0y = state.u, state.v
    Fx = u0x + dt * adv_dif(u0x, u0x, u0y, nu, 1)
    Fy = u0y + dt * adv_dif(u0y, u0x, u0y, nu, 2)
    u1, v1, p = _update_up(cfg, consts, Fx, Fy, cx, cy, Fx, Fy, state.p)
    Fx2 = u0x + dt * adv_dif(u1, u1, v1, nu, 1)
    Fy2 = u0y + dt * adv_dif(v1, u1, v1, nu, 2)
    u2, v2, p = _update_up(cfg, consts, Fx2, Fy2, cx, cy, Fx2, Fy2, p)
    return BDIMState(set_bc_u(0.5 * (u1 + u2), cfg.u_inf), set_bc_v(0.5 * (v1 + v2)), p)


def bdim_step(cfg: BDIMConfig, consts: BDIMConsts, state: BDIMState) -> BDIMState:
    """One predictor + corrector step (semi-Lagrangian), or the QUICK +
    viscous branch when ``cfg.quick``."""
    if cfg.quick:
        return bdim_step_quick(cfg, consts, state)
    dt = cfg.dt
    cx = consts.del_x * dt
    cy = consts.del_y * dt
    u0x, u0y = state.u, state.v
    # predictor: single-velocity advection (u == u0 here)
    Fx = advect_single(state.u, u0x, u0y, dt, btype=1)
    Fy = advect_single(state.v, u0x, u0y, dt, btype=2)
    u, v, p = _update_up(cfg, consts, Fx, Fy, cx, cy, Fx, Fy, state.p)
    # corrector
    usx, usy = u, v
    Fx = advect_double(u0x, usx, usy, u0x, u0y, dt, btype=1)
    Fy = advect_double(u0y, usx, usy, u0x, u0y, dt, btype=2)
    gx, gy = gradient(p)
    dpx = advect_double(gx * (0.5 * dt), usx, usy, u0x, u0y, dt, btype=1)
    dpy = advect_double(gy * (0.5 * dt), usx, usy, u0x, u0y, dt, btype=2)
    u, v, p = _update_up(cfg, consts, Fx - dpx, Fy - dpy, cx * 0.5, cy * 0.5, Fx, Fy, p)
    return BDIMState(u, v, p)


# ---------------------------------------------------------------------------
# force integration


def press_force(p: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Pressure force, the closed integral of p n dl over polygon segments
    (bilinear p at segment midpoints x length x outward normal, nx = ty,
    ny = -tx with the tangent from point i to i+1).

    p [D, N, N]; coords [D, *K, M, 2]; returns [D, *K, 2] = (Fx, Fy)."""
    b = torch.roll(coords, -1, dims=-2)
    seg = coords - b
    length = torch.sqrt(seg.square().sum(-1) + 1e-20)
    tx = seg[..., 0] / length
    ty = seg[..., 1] / length
    nx, ny = ty, -tx
    cen = 0.5 * (coords + b)
    pdl = _bilinear(p, cen[..., 0], cen[..., 1]) * length
    return torch.stack([(pdl * nx).sum(-1), (pdl * ny).sum(-1)], dim=-1)


def momentum_balance_drag(u: torch.Tensor, p: torch.Tensor, i_in: int = 5,
                          i_out: Optional[int] = None) -> torch.Tensor:
    """Control-volume streamwise force per design: the integral of p + u^2
    over the inlet column minus the same over the outlet column: [D]."""
    io = u.shape[-2] - 6 if i_out is None else i_out
    f = lambda i: (p[:, i, 1:-1] + u[:, i, 1:-1].square()).sum(-1)
    return f(i_in) - f(io)


# ---------------------------------------------------------------------------
# batched simulation


def _coords_on(coords, device) -> torch.Tensor:
    """fp32 polygons: a tensor stays on its device, an array goes to
    ``device`` (the card unless the CPU is asked for by name)."""
    from ..utils.device import resolve_device  # here: utils imports this module

    if isinstance(coords, torch.Tensor):
        return coords.to(torch.float32)
    return torch.as_tensor(coords, dtype=torch.float32, device=resolve_device(device))


def simulate_flow_batch(cfg: BDIMConfig, coords_batch, n_warmup: int, n_record: int,
                        device: str | torch.device = "cuda"):
    """Run BDIM for D designs at once and record fields and per-body forces.

    Step to t = n_warmup, then record (u, v, p) interiors and the pressure
    force on each body for n_record steps.

    Args:
        coords_batch: [D, K, M, 2] (or [D, M, 2]) polygons in grid units, a
            tensor (the run stays on its device) or an array (placed on
            ``device``; without a card, ``device="cpu"`` must be given).

    Returns:
        fields: (u, v, p) each [D, n_record, n, n] (interior, [i=x, j=y])
        forces: [D, n_record, K, 2]
    """
    coords = _coords_on(coords_batch, device)
    if coords.ndim == 3:
        coords = coords[:, None]
    with torch.no_grad():
        consts = make_consts(cfg, coords)
        state = init_state(cfg, coords.shape[0], coords.device)
        for _ in range(n_warmup):
            state = bdim_step(cfg, consts, state)
        us, vs, ps, fs = [], [], [], []
        for _ in range(n_record):
            state = bdim_step(cfg, consts, state)
            us.append(state.u[:, 1:-1, 1:-1])
            vs.append(state.v[:, 1:-1, 1:-1])
            ps.append(state.p[:, 1:-1, 1:-1])
            fs.append(press_force(state.p, coords))
    stack = lambda xs: torch.stack(xs, dim=1)
    return (stack(us), stack(vs), stack(ps)), stack(fs)


def simulate_flow(cfg: BDIMConfig, coords, n_warmup: int, n_record: int,
                  device: str | torch.device = "cuda"):
    """One design ([M, 2] or [K, M, 2]): fields [n_record, n, n] each and
    forces [n_record, K, 2]; ``coords`` is placed as in ``simulate_flow_batch``."""
    coords = _coords_on(coords, device)
    (us, vs, ps), fs = simulate_flow_batch(cfg, coords[None], n_warmup, n_record)
    return (us[0], vs[0], ps[0]), fs[0]
