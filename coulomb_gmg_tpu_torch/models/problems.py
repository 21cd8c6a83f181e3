"""Analytic problem definitions (RHS, exact solution, boundary values).

Counterpart of coulomb_gmg_tpu/models/problems.py (the reference's
``Function`` objects in ``include/step_50.h:216-386``).  Points are
``(N, dim)`` tensors; results are ``(N,)`` tensors of the points' dtype and
device.  The moments (dipole, quadrupole) are float64 numpy, as in the JAX
module.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT_PI = math.sqrt(math.pi)


def step16_rhs(points: torch.Tensor) -> torch.Tensor:
    """f = 10 (include/step_50.h:240-244)."""
    return torch.full(points.shape[:-1], 10.0, dtype=points.dtype,
                      device=points.device)


def step16_coefficient(points: torch.Tensor) -> torch.Tensor:
    """c = 5 inside r < 0.5, else 1 (include/step_50.h:246-254)."""
    r2 = torch.sum(points * points, dim=-1)
    return torch.where(r2 < 0.25, 5.0, 1.0).to(points.dtype)


def gaussian_coefficient(points: torch.Tensor) -> torch.Tensor:
    """c = 1 (include/step_50.h:331-336)."""
    return torch.ones(points.shape[:-1], dtype=points.dtype,
                      device=points.device)


def gaussian_rhs(points: torch.Tensor, r_c: float) -> torch.Tensor:
    """Analytic two-Gaussian RHS used when no LAMMPS file is given:
    (8 e^{-4 r^2/r_c^2} - e^{-r^2/r_c^2}) / (r_c^3 pi^{3/2})
    (include/step_50.h:322-329)."""
    r2 = torch.sum(points * points, dim=-1)
    c = r2 / (r_c * r_c)
    return (8.0 * torch.exp(-4.0 * c) - torch.exp(-c)) / (r_c ** 3
                                                          * math.pi ** 1.5)


def analytic_solution(points: torch.Tensor, atom_positions: torch.Tensor,
                      charges: torch.Tensor, r_c: float) -> torch.Tensor:
    """phi(x) = sum_i q_i erf(|x - X_i| / r_c) / |x - X_i|, with the
    r -> 0 limit 2 q / (sqrt(pi) r_c) (include/step_50.h:338-353)."""
    inv_const = 1.0 / (SQRT_PI * r_c)
    diff = points[..., None, :] - atom_positions
    r = torch.sqrt(torch.sum(diff * diff, dim=-1))
    small = r < 1e-10
    safe_r = torch.where(small, torch.ones_like(r), r)
    vals = torch.where(small, torch.full_like(r, 2.0 * inv_const),
                       torch.special.erf(safe_r / r_c) / safe_r)
    return torch.sum(vals * charges, dim=-1)


def analytic_solution_gradient(points: torch.Tensor,
                               atom_positions: torch.Tensor,
                               charges: torch.Tensor,
                               r_c: float) -> torch.Tensor:
    """grad phi = sum_i q_i radial(r_i) (x - X_i) / r_i with
    radial(r) = (2 r e^{-(r/r_c)^2} / (sqrt(pi) r_c) - erf(r/r_c)) / r^2,
    zero at an atom (r < 1e-14, the removable singularity;
    include/step_50.h:355-369).  Returns ``(..., dim)``."""
    inv_const = 1.0 / (SQRT_PI * r_c)
    diff = points[..., None, :] - atom_positions
    r = torch.sqrt(torch.sum(diff * diff, dim=-1))
    near = r < 1e-14
    safe_r = torch.where(near, torch.ones_like(r), r)
    rq = safe_r / r_c
    radial = (2.0 * safe_r * torch.exp(-rq * rq) * inv_const
              - torch.special.erf(rq)) / (safe_r * safe_r)
    radial = torch.where(near, torch.zeros_like(radial), radial)
    unit = diff / safe_r[..., None]
    return torch.sum((charges * radial)[..., None] * unit, dim=-2)


def analytic_solution_without_lammps(points: torch.Tensor,
                                     r_c: float) -> torch.Tensor:
    """(erf(2 r / r_c) - erf(r / r_c)) / (4 pi r), with its r -> 0 limit
    (include/step_50.h:371-376)."""
    r = torch.sqrt(torch.sum(points * points, dim=-1))
    small = r < 1e-14
    safe_r = torch.where(small, torch.ones_like(r), r)
    limit = (2.0 / SQRT_PI) * (2.0 - 1.0) / (4.0 * math.pi * r_c)
    val = (torch.special.erf(2.0 * safe_r / r_c)
           - torch.special.erf(safe_r / r_c)) / (4.0 * math.pi * safe_r)
    return torch.where(small, torch.full_like(r, limit), val)


def nonzero_dbc(points: torch.Tensor, x0, dipole, quadrupole) -> torch.Tensor:
    """Multipole far-field boundary values:
    p0.(x-x0)/|x-x0|^3 + 0.5 (x-x0)^T Q0 (x-x0) / |x-x0|^5
    (include/step_50.h:378-385); dipole-only in practice, since the
    reference zeroes the quadrupole (src/step-50.cc:624)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=points.dtype,
                                     device=points.device)
    d = points - as_t(x0)
    norm = torch.sqrt(torch.sum(d * d, dim=-1))
    xqx = torch.einsum("...i,ij,...j->...", d, as_t(quadrupole), d)
    return (d @ as_t(dipole)) / norm ** 3 + 0.5 * xqx / norm ** 5


def compute_dipole_moment(atom_positions, charges) -> np.ndarray:
    """p0 = sum_k q_k X_k (src/step-50.cc:588-590), float64 numpy."""
    return np.asarray(atom_positions).T @ np.asarray(charges)


def compute_quadrupole_moment(quad_points, jxw, rho) -> np.ndarray:
    """Q0 = integral rho(x) (3 x (x) x - |x|^2 I) dV by quadrature
    (src/step-50.cc:595-623): ``quad_points`` (cells, q, dim), ``jxw`` and
    ``rho`` (cells, q).  The reference zeroes the result right after
    computing it (src/step-50.cc:624); this is the integral itself."""
    dim = np.asarray(quad_points).shape[-1]
    x = np.asarray(quad_points).reshape(-1, dim)
    w = (np.asarray(jxw) * np.asarray(rho)).reshape(-1)
    S = (x * w[:, None]).T @ x
    return 3.0 * S - np.trace(S) * np.eye(dim)


def quadrupole_from_forest(forest, points_ref, weights, rho,
                           chunk: int = 65536) -> np.ndarray:
    """The quadrupole integral over the mesh, second moments accumulated
    per chunk of cells in float32 (as the JAX function does) into float64;
    ``rho`` is the (n_cells, n_q) density at the reference points."""
    dim = forest.dim
    lower = forest.cell_lower().astype(np.float32)
    h = forest.cell_h().astype(np.float32)
    pr = np.asarray(points_ref, np.float32)
    wq = np.asarray(weights, np.float32)
    rho = np.asarray(rho, np.float32)
    S = np.zeros((dim, dim), np.float64)
    for s in range(0, forest.n_cells, chunk):
        e = min(s + chunk, forest.n_cells)
        x = (lower[s:e, None, :] + h[s:e, None, None] * pr[None, :, :])
        x = x.reshape(-1, dim)
        w = ((h[s:e] ** dim)[:, None] * wq[None, :] * rho[s:e]).reshape(-1)
        S += ((x * w[:, None]).T @ x).astype(np.float64)
    return 3.0 * S - np.trace(S) * np.eye(dim)
