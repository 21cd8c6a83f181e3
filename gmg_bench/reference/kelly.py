"""Plain float64 reference of the error indicator and the marking
(``estimate_error_and_mark_cells``, src/step-50.cc:1020-1090) on a Q1 mesh
of gmg_bench/reference/fem.py:

* the Kelly indicator with the cell-diameter strategy
  (``KellyErrorEstimator::estimate``, :1040-1050): every interior face
  ``F`` adds ``diam_K int_F [d u_h / d n]^2`` to each cell ``K`` beside it,
  the jump of the normal derivative taken at the two-point Gauss points of
  the finer side's face (a face between a cell and a coarser one is the
  finer cell's whole face and a quarter of the coarser one's);
* the volume term (:1052-1082): ``diam_K^2 int_K (lap u_h + 4 pi rho~)^2``
  at the load's rule, two Gauss points an axis, ``rho~`` the density of
  gmg_bench/reference/density.py, which already carries the normalisation
  ``4 pi / (r_c^3 pi^1.5)``: the reference multiplies by ``4 pi`` once
  more, and so does this.  ``lap u_h`` is zero for Q1 on boxes;
* ``eta_K = sqrt`` of the sum; the threshold ``fraction * max eta``
  (:1084-1089, ``refine_fraction_of_max``), and the cells above it marked;
* the marks closed under the 2:1 vertex balance that the mesh keeps: a
  marked cell of level ``l`` marks every active cell of level ``l - 1``
  whose closure touches its own, finest level first, so that no vertex of
  the refined mesh joins cells two levels apart.

Departures from src/step-50.cc: the faces are found from the active cells'
``(level, ijk)`` (deal.II walks its face iterators); the jump is taken at
physical points mapped into each side, not from deal.II's subface
``FEFaceValues``; the sums over faces and cells run in one float64 order,
not per MPI rank; the balance closure is that of the mesh's vertex
balance, which deal.II's ``limit_level_difference_at_vertices`` keeps.
"""

from __future__ import annotations

import math

import torch

from gmg_bench.reference.fem import CORNERS, GAUSS2, Mesh


def cell_keys(level: torch.Tensor, ijk: torch.Tensor, side: int):
    """One int64 key a cell ``(level, ijk)``, ``ijk < side`` on every
    axis."""
    return ((level * side + ijk[:, 0]) * side + ijk[:, 1]) * side + ijk[:, 2]


class Cells:
    """Lookup of a mesh's active cells by ``(level, ijk)``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.side = mesh.S
        self.keys, self.order = torch.sort(
            cell_keys(mesh.level, mesh.ijk, self.side))

    def find(self, level: torch.Tensor, ijk: torch.Tensor) -> torch.Tensor:
        """Active index of each cell ``(level, ijk)``, -1 where it is not
        active or lies outside the grid of its level."""
        m = self.mesh
        lv = level.expand(ijk.shape[0]) if level.dim() == 0 else level
        n = m.reps << lv.clamp(min=0)
        inside = ((ijk >= 0) & (ijk < n[:, None])).all(-1) & (lv >= 0)
        k = cell_keys(lv.clamp(min=0), ijk.clamp(min=0), self.side)
        pos = torch.searchsorted(self.keys, k).clamp(max=len(self.keys) - 1)
        hit = inside & (self.keys[pos] == k)
        return torch.where(hit, self.order[pos], -1)


def _normal_derivative(mesh: Mesh, u: torch.Tensor, cells: torch.Tensor,
                       x: torch.Tensor, axis: int) -> torch.Tensor:
    """``d u_h / d x_axis`` in each cell of ``cells`` (m,) at its points
    ``x`` (m, k, 3), from the cell's corner values."""
    h = mesh.h[cells]
    t = (x - mesh.cell_lower[cells, None, :]) / h[:, None, None]
    c = CORNERS.to(mesh.device, torch.float64)                   # (8, 3)
    f = torch.where(c[None, None] == 1, t[:, :, None, :],
                    1.0 - t[:, :, None, :])                      # (m, k, 8, 3)
    others = [d for d in range(3) if d != axis]
    dphi = (2.0 * c[:, axis] - 1.0) * f[..., others].prod(-1)    # (m, k, 8)
    return (dphi * u[mesh.cell2v[cells]][:, None, :]).sum(-1) / h[:, None]


def face_terms(mesh: Mesh, u: torch.Tensor) -> torch.Tensor:
    """``sum_F diam_K int_F [d u_h / d n]^2`` of every cell (C,)."""
    dev = mesh.device
    found = Cells(mesh)
    g = torch.tensor(GAUSS2, dtype=torch.float64, device=dev)
    tang = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    diam = mesh.h * math.sqrt(3.0)
    out = torch.zeros(mesh.n_cells, dtype=torch.float64, device=dev)
    every = torch.arange(mesh.n_cells, device=dev)
    for axis in range(3):
        free = [d for d in range(3) if d != axis]
        for side in (0, 1):
            nb = mesh.ijk.clone()
            nb[:, axis] += 2 * side - 1
            same = found.find(mesh.level, nb)
            coarse = found.find(mesh.level - 1, nb >> 1)
            # a face between two cells of one level counts once, from its
            # low side; a face to a coarser cell, from the finer side; a
            # face to finer cells, from theirs
            pairs = [(every[(same >= 0) & (side == 1)], same),
                     (every[(same < 0) & (coarse >= 0)], coarse)]
            for fine, other in pairs:
                if fine.numel() == 0:
                    continue
                other = other[fine]
                h = mesh.h[fine]
                t = torch.empty(fine.numel(), 4, 3, dtype=torch.float64,
                                device=dev)
                t[..., axis] = float(side)
                t[..., free[0]] = tang[:, 0]
                t[..., free[1]] = tang[:, 1]
                x = mesh.cell_lower[fine, None, :] + h[:, None, None] * t
                jump = (_normal_derivative(mesh, u, fine, x, axis)
                        - _normal_derivative(mesh, u, other, x, axis))
                integral = (jump * jump).sum(-1) * 0.25 * h * h
                out.index_add_(0, fine, diam[fine] * integral)
                out.index_add_(0, other, diam[other] * integral)
    return out


def indicator(mesh: Mesh, u: torch.Tensor, rho: torch.Tensor,
              volume_term: bool = True) -> torch.Tensor:
    """``eta`` of every cell (C,), float64: the face terms of the vertex
    values ``u`` (V,), plus the volume term of the density ``rho`` (C, 8)
    at the load's Gauss points where ``volume_term``."""
    eta2 = face_terms(mesh, u.to(mesh.device, torch.float64))
    if volume_term:
        f = 4.0 * math.pi * rho.to(torch.float64)
        vol = (f * f).sum(-1) * 0.125 * mesh.h ** 3
        eta2 = eta2 + 3.0 * mesh.h * mesh.h * vol
    return torch.sqrt(eta2)


def balance_closure(mesh: Mesh, marks: torch.Tensor) -> torch.Tensor:
    """``marks`` (C,) bool with every cell that the 2:1 vertex balance
    makes split with them."""
    found = Cells(mesh)
    out = marks.clone()
    corners = CORNERS.to(mesh.device)
    for lv in range(mesh.L, 0, -1):
        src = torch.nonzero(out & (mesh.level == lv)).squeeze(1)
        if src.numel() == 0:
            continue
        a = mesh.ijk[src]
        top = (mesh.reps << (lv - 1)) - 1
        qmin = ((a - 1) >> 1).clamp(min=0)
        qmax = ((a + 1) >> 1).clamp(max=top)
        cand = (qmin[:, None, :] + corners[None] * (qmax - qmin)[:, None, :])
        hit = found.find(torch.tensor(lv - 1, device=mesh.device),
                         cand.reshape(-1, 3))
        out[hit[hit >= 0]] = True
    return out


def split_cells(level, ijk, next_level, next_ijk, reps: int,
                device) -> torch.Tensor:
    """(C,) bool: the cells ``(level, ijk)`` of one mesh that are no longer
    active in the next mesh ``(next_level, next_ijk)``."""
    def t(a):
        return torch.as_tensor(a, device=device).to(torch.int64)

    lv, nl = t(level), t(next_level)
    side = reps << int(max(int(lv.max()), int(nl.max())))
    now = cell_keys(lv, t(ijk), side)
    return ~torch.isin(now, cell_keys(nl, t(next_ijk), side))
