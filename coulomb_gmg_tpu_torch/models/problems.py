"""Analytic problem definitions (RHS, exact solution, boundary values).

Counterpart of coulomb_gmg_tpu/models/problems.py for the functions the
production slice uses (the reference's ``Function`` objects in
``include/step_50.h:322-385``).  Points are ``(N, dim)`` tensors; results
are ``(N,)`` tensors of the points' dtype and device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT_PI = math.sqrt(math.pi)


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
