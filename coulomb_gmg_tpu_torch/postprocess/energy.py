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
from coulomb_gmg_tpu_torch.utils.timer import span


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
    ucell = np.asarray(u)[forest.dofs_of(degree).host.cell2dof[cells]]
    phi = np.asarray(basis_at(forest.dim, degree, t)[0])   # (n_pts, nb)
    return np.sum(phi * ucell, axis=1)


def electrostatic_energy(forest: Forest, u: np.ndarray, positions: np.ndarray,
                         charges: np.ndarray, r_c: float, degree: int = 1,
                         phi_at_atoms: np.ndarray = None) -> Dict[str, float]:
    """The energy split of src/step-50.cc:1310-1420 (float64 numpy);
    ``phi_at_atoms``: the solution at the atoms, if already evaluated."""
    d = positions[:, None, :] - positions[None, :, :]
    r = np.sqrt((d * d).sum(-1))
    iu = np.triu_indices(len(charges), 1)
    qq = np.outer(charges, charges)
    analytic = float((qq[iu] / r[iu]).sum())
    short = float((qq[iu] * erfc(r[iu] / r_c) / r[iu]).sum())
    if phi_at_atoms is None:
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

    ``dtype`` float32 is the production path (the exact gradient through
    :func:`exact_gradient`, the kernel on the card); float64 evaluates it
    with the plain version (the kernel is float32 only) and is the oracle
    of the float32 path.  See :func:`energy_norm_error_sq`; here the span
    ``fe.gradient`` ends with the result's read, so it holds the device's
    work."""
    ops, grad_fn = enorm_operands(forest, tables, u, positions, charges,
                                  device, dtype)
    with span("fe.gradient"):
        return float(torch.sqrt(enorm_loop(*ops, r_c, chunk, grad_fn)))


def energy_norm_error_sq(forest: Forest, tables: ElementTables, u,
                         positions, charges, r_c: float, device,
                         dtype: torch.dtype = torch.float32,
                         chunk: int = 1 << 18,
                         cells: range = None) -> torch.Tensor:
    """The squared error of :func:`energy_norm_error` summed over the cells
    ``cells`` (default all), a float64 0-dim tensor on ``device``: the
    operands of :func:`enorm_operands`, and :func:`enorm_loop` over them in
    chunks of ``chunk`` cells (the span ``fe.gradient``)."""
    ops, grad_fn = enorm_operands(forest, tables, u, positions, charges,
                                  device, dtype, cells)
    with span("fe.gradient"):
        return enorm_loop(*ops, r_c, chunk, grad_fn)


def enorm_operands(forest: Forest, tables: ElementTables, u, positions,
                   charges, device, dtype: torch.dtype,
                   cells: range = None) -> tuple:
    """(the operands of :func:`enorm_loop` but ``r_c``, ``chunk`` and the
    gradient, on ``device``; the exact gradient for ``dtype``): the DoF
    values, sizes and corners of the cells ``cells`` (default all), the
    rule's tables and the packed atoms, sent to the device once (the span
    ``fe.operands``)."""
    dev = torch.device(device)
    cells = range(forest.n_cells) if cells is None else cells
    grad_fn = exact_gradient if dtype == torch.float32 else \
        exact_gradient_plain

    def put(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    sel = slice(cells.start, cells.stop)
    with span("fe.operands"):
        c2d = forest.dofs_of(tables.degree).cell2dof[sel].to(dev)
        u_d = put(np.asarray(u, np.float64))
        ops = (u_d[c2d], put(forest.cell_h()[sel]),
               put(forest.cell_lower()[sel]), put(tables.dphi),
               put(tables.points), put(tables.weights, torch.float64),
               pack_atoms(positions, charges, dev, dtype))
    return ops, grad_fn


def enorm_loop(ucell: torch.Tensor, h: torch.Tensor, lower: torch.Tensor,
               dphi: torch.Tensor, pref: torch.Tensor, w: torch.Tensor,
               atoms: torch.Tensor, r_c: float, chunk: int,
               grad_fn) -> torch.Tensor:
    """The device loop of :func:`energy_norm_error_sq` over cells given by
    their DoF values ``ucell`` (C, nb), sizes ``h`` (C,) and lower corners
    ``lower`` (C, dim), in chunks of ``chunk`` cells: per chunk ``grad_h``
    from ``ucell`` and the basis gradients ``dphi`` (n_q, nb, dim), the
    exact gradient ``grad_fn`` at ``lower + h * pref`` over ``atoms``
    (ops/density.py:pack_atoms), and the squared difference weighted by
    ``w`` (n_q,) float64, summed in float64.  Returns the sum, a float64
    0-dim tensor on the tensors' device."""
    dim, n_q = lower.shape[1], pref.shape[0]
    acc = torch.zeros((), dtype=torch.float64, device=h.device)
    for s in range(0, h.shape[0], chunk):
        e = min(s + chunk, h.shape[0])
        hh = h[s:e]
        grad_h = torch.einsum("cb,qbd->cqd", ucell[s:e], dphi) \
            / hh[:, None, None]
        pts = lower[s:e, None, :] + hh[:, None, None] * pref
        grad_ex = grad_fn(pts.reshape(-1, dim), atoms, r_c)
        diff2 = ((grad_h - grad_ex.reshape(e - s, n_q, dim)) ** 2).sum(-1)
        acc += ((diff2.to(torch.float64) @ w)
                * hh.to(torch.float64) ** dim).sum()
    return acc
