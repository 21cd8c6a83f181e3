"""Electrostatic energy and FE-error postprocess.

Counterpart of coulomb_gmg_tpu/postprocess/energy.py, which imports jax at
the top, so the port carries its own copy of the numpy functions:

* :func:`electrostatic_energy` (``postprocess_electrostatic_energy``,
  src/step-50.cc:1310-1420): analytic pairwise energy, and its split into
  short-range, FE long-range (point evaluation of the solution) and self
  energy, with :func:`locate_cells` and :func:`point_values`;
* :func:`energy_norm_error` (``postprocess_error_in_energy_norm``,
  src/step-50.cc:1423-1461): ``sqrt(sum_c int ||grad u_h - grad u||^2)``
  on the device, the exact gradient through ops/gradient.py (kernel on the
  card), accumulated in float64 with one scalar read at the end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from scipy.special import erfc

from coulomb_gmg_tpu_torch.mesh.forest import Forest, KeyIndex
from coulomb_gmg_tpu_torch.ops.q1 import ElementTables, basis_at
from coulomb_gmg_tpu_torch.ops.density import pack_atoms
from coulomb_gmg_tpu_torch.ops.gradient import (exact_gradient,
                                                exact_gradient_plain)


def locate_cells(forest: Forest, points: np.ndarray) -> np.ndarray:
    """Active cell index containing each point (the analogue of
    ``GridTools::find_active_cell_around_point``, src/step-50.cc:1353)."""
    per_level = {}
    lvl = forest.level.astype(np.int64)
    for l in range(forest.n_levels):
        sel = np.where(lvl == l)[0]
        keys = forest.level_cell_key(l, forest.ijk[sel])
        order = np.argsort(keys)
        per_level[l] = (KeyIndex(keys), sel[order])
    out = np.full(len(points), -1, dtype=np.int64)
    for l in range(forest.n_levels - 1, -1, -1):
        need = out < 0
        if not need.any():
            break
        h = forest.h(l)
        ijk = np.floor((points[need] - forest.lower) / h).astype(np.int64)
        ijk = np.clip(ijk, 0, forest.side(l) - 1)
        ki, act = per_level[l]
        pos = ki.lookup(forest.level_cell_key(l, ijk))
        hit = pos >= 0
        idx = np.where(need)[0]
        out[idx[hit]] = act[pos[hit]]
    if (out < 0).any():
        raise ValueError("point outside mesh")
    return out


def point_values(forest: Forest, u: np.ndarray, points: np.ndarray,
                 degree: int = 1) -> np.ndarray:
    """FE field values at arbitrary points (vectorized over points)."""
    cells = locate_cells(forest, points)
    lower = forest.cell_lower(cells)
    h = forest.cell_h(cells)
    t = (points - lower) / h[:, None]
    ucell = np.asarray(u)[forest.dofs_of(degree).cell2dof[cells]]
    phi = np.asarray(basis_at(forest.dim, degree, t)[0])   # (n_pts, nb)
    return np.sum(phi * ucell, axis=1)


def electrostatic_energy(forest: Forest, u: np.ndarray, positions: np.ndarray,
                         charges: np.ndarray, r_c: float,
                         degree: int = 1) -> Dict[str, float]:
    """The energy split of src/step-50.cc:1310-1420 (float64 numpy)."""
    d = positions[:, None, :] - positions[None, :, :]
    r = np.sqrt((d * d).sum(-1))
    iu = np.triu_indices(len(charges), 1)
    qq = np.outer(charges, charges)
    analytic = float((qq[iu] / r[iu]).sum())
    short = float((qq[iu] * erfc(r[iu] / r_c) / r[iu]).sum())
    phi_at_atoms = point_values(forest, u, positions, degree=degree)
    fe_long = float(0.5 * np.sum(charges * phi_at_atoms))
    self_e = float(np.sum(charges ** 2) / (np.sqrt(np.pi) * r_c))
    total_split = short + fe_long - self_e
    return {
        "analytic": analytic,
        "short_range": short,
        "fe_long_range": fe_long,
        "self_energy": self_e,
        "total_split": total_split,
        "abs_error": abs(abs(analytic) - abs(total_split)),
        "rel_error": abs((abs(analytic) - abs(total_split)) / analytic),
    }


def energy_norm_error(forest: Forest, tables: ElementTables, u,
                      positions, charges, r_c: float, device,
                      dtype: torch.dtype = torch.float32,
                      chunk: int = 1 << 18) -> float:
    """sqrt( sum_c int_c ||grad u_h - grad u_exact||^2 dx ) with the rule of
    ``tables`` (the Laplace table, src/step-50.cc:1423-1461).

    Per chunk of cells on ``device``: ``grad_h`` from the cell's DoF
    values, the exact gradient at ``lower + h * pref``, and the weighted
    squared difference, summed in float64 on the device; one scalar is read
    at the end.  ``dtype`` float32 is the production path (the exact
    gradient through :func:`exact_gradient`, the kernel on the card);
    float64 evaluates it with the plain version (the kernel is float32
    only) and is the oracle of the float32 path."""
    dev = torch.device(device)
    dim = forest.dim
    n = forest.n_cells
    grad_fn = exact_gradient if dtype == torch.float32 else \
        exact_gradient_plain

    def put(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    c2d = put(forest.dofs_of(tables.degree).cell2dof, torch.int64)
    u_d = put(np.asarray(u, np.float64))
    h = put(forest.cell_h())
    lower = put(forest.cell_lower())
    dphi = put(tables.dphi)                             # (n_q, nb, dim)
    pref = put(tables.points)                           # (n_q, dim)
    w = put(tables.weights, torch.float64)              # (n_q,)
    atoms = pack_atoms(positions, charges, dev, dtype)
    n_q = pref.shape[0]
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        hh = h[s:e]
        grad_h = torch.einsum("cb,qbd->cqd", u_d[c2d[s:e]], dphi) \
            / hh[:, None, None]
        pts = lower[s:e, None, :] + hh[:, None, None] * pref
        grad_ex = grad_fn(pts.reshape(-1, dim), atoms, r_c)
        diff2 = ((grad_h - grad_ex.reshape(e - s, n_q, dim)) ** 2).sum(-1)
        acc += ((diff2.to(torch.float64) @ w)
                * hh.to(torch.float64) ** dim).sum()
    return float(torch.sqrt(acc))
