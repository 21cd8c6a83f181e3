"""Geometric multigrid preconditioner with local smoothing over CSR levels.

Counterpart of coulomb_gmg_tpu/solver/multigrid.py, the re-design of the
reference's deal.II multigrid stack (``src/step-50.cc:954-992``): level
matrices with refinement-edge and boundary dofs eliminated
(``assemble_multigrid``, src/step-50.cc:835-933), interface ("edge")
matrices, prolongation matrices (``MGTransferPrebuilt``), a CG coarse
solve (``MGCoarseGridIterativeSolver``) and the V-cycle of ``Multigrid`` +
``PreconditionMG``.  Level and interface matrices are assembled on the
device (fem/card_assembly.py; the JAX package assembles them on the host)
and applied there through the ELL kernel (ops/spmv.py:CSR).

The cycle is the Janssen-Kanschat local-smoothing algorithm:

  copy_to:   d_l = residual at dofs of *active* level-l cells,
             zeroed at refinement-edge dofs of level l
  descend l: u_l = Smooth^m(A_l, 0, d_l)
             r_l = d_l - A_l u_l - A_l^if u_l
             d_{l-1} += P_l^T r_l
  coarse:    u_0 = CG(A_0, d_0)  to 1e-10
  ascend l:  u_l += P_l u_{l-1}
             d_l -= (A_l^if)^T u_l
             u_l = Smooth^m(A_l, u_l, d_l)
  copy_from: global[dof] = u_l[dof] from the level where the dof lies on an
             active level-l cell and is not at that level's refinement edge.

Copies to and from the levels are indexed reads and writes over unique
indices, so the cycle is the same on every run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.utils.timer import spanned
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.mesh.dofs import DofInfo, LevelDofs
from coulomb_gmg_tpu_torch.fem import card_assembly as card
from coulomb_gmg_tpu_torch.ops.q1 import lagrange_nodes_1d, _lagrange_eval
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.ops.smoothers import (
    MGSmoother, make_jacobi, make_mc_ssor, make_ssor, make_chebyshev,
    lattice_color)
from coulomb_gmg_tpu_torch.solver.cg import cg, host_float


def level_matrix(cell2dof: torch.Tensor, edge: torch.Tensor,
                 bnd: torch.Tensor, k: card.CellMatrices, dtype) -> CSR:
    """A_l with the refinement-edge (``edge``) and boundary (``bnd``)
    level dofs eliminated: deal.II's homogeneous
    ``boundary_constraints[level]`` (src/step-50.cc:853-864)."""
    p = card.plan(cell2dof, card.eliminated(edge | bnd))
    data, _ = card.assemble(p, k, dtype=dtype)
    p.release()
    return CSR.from_pattern(p.pattern.indptr, p.pattern.indices, data)


def build_interface_csr(cell2dof: torch.Tensor, edge: torch.Tensor,
                        bnd: torch.Tensor, k: card.CellMatrices,
                        dtype) -> CSR:
    """Interface ("edge") matrix: raw level assembly masked to entries
    (i at edge, j not at edge, neither at domain boundary), the keep
    condition of src/step-50.cc:896-920, the zeros kept in the pattern.
    ``cell2dof`` may hold only the level cells that touch the refinement
    edge (``k`` their element matrices); the pattern spans the full level
    dof numbering."""
    p = card.plan(cell2dof, card.eliminated(torch.zeros_like(edge)),
                  keep=lambda r, c: edge[r] & ~edge[c] & ~bnd[r] & ~bnd[c])
    data, _ = card.assemble(p, k, dtype=dtype)
    p.release()
    return CSR.from_pattern(p.pattern.indptr, p.pattern.indices, data)


def build_prolongation(forest: Forest, dofs: DofInfo, l: int,
                       np_dtype=np.float64, device="cpu") -> CSR:
    """P_l: level l-1 -> level l embedding.  Each level-l dof interpolates
    through the parent level-(l-1) cell's Q_p basis (Q1: the trilinear
    2^dim-point stencil; ``MGTransferPrebuilt::build_matrices``,
    src/step-50.cc:957-958)."""
    dim = forest.dim
    dofs = dofs.host
    p = dofs.degree
    ld, lc = dofs.levels[l], dofs.levels[l - 1]
    level_ijk, _ = forest.level_cells_host[l]
    parent = level_ijk // 2
    child = (level_ijk & 1).astype(np.int64)            # (m, dim)
    par_key = forest.level_cell_key(l - 1, parent)
    pc_ijk, _ = forest.level_cells_host[l - 1]
    pc_key = forest.level_cell_key(l - 1, pc_ijk)
    order = np.argsort(pc_key)
    ppos = order[np.searchsorted(pc_key[order], par_key)]
    parent_dofs = lc.cell2dof[ppos]                      # (m, (p+1)^dim)

    nb = (p + 1) ** dim
    # 1D parent-basis values at the child-node fractions (c + a/p)/2
    nodes1 = lagrange_nodes_1d(p)
    tvals = np.array([[(c + a / p) / 2.0 for a in range(p + 1)]
                      for c in (0, 1)])
    val1d = np.stack([_lagrange_eval(nodes1, tvals[c])[0] for c in (0, 1)])
    rows, cols, vals = [], [], []
    for v in range(nb):
        digits_v = [(v // ((p + 1) ** d)) % (p + 1) for d in range(dim)]
        child_dof = ld.cell2dof[:, v]
        for pv in range(nb):
            digits_p = [(pv // ((p + 1) ** d)) % (p + 1) for d in range(dim)]
            w = np.ones(len(level_ijk))
            for d in range(dim):
                w = w * val1d[child[:, d], digits_v[d], digits_p[d]]
            nz = w != 0.0
            rows.append(child_dof[nz])
            cols.append(parent_dofs[nz, pv])
            vals.append(w[nz])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    # dedupe (each dof interpolated identically from any parent holding it)
    pair = rows * np.int64(lc.n_dofs) + cols
    _, first = np.unique(pair, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    order = np.lexsort([cols, rows])
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(ld.n_dofs + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(n_rows=ld.n_dofs, n_cols=lc.n_dofs, indptr=indptr,
               indices=cols, rowids=rows,
               data=upload(vals.astype(np_dtype), device))


@dataclass
class GMGPreconditioner:
    """One V-cycle of local-smoothing GMG, used as a CG preconditioner.
    ``copy_global`` / ``copy_level`` are numpy index arrays;
    ``coarse_iterations`` records the coarse CG's count of each V-cycle;
    each coarse solve is a span ``solve.coarse`` of the run."""

    matrices: List[CSR]                 # A_l per level
    interfaces: List[Optional[CSR]]     # A_l^if (None at level 0)
    prolongations: List[Optional[CSR]]  # P_l (None at level 0)
    smoothers: List[Optional[MGSmoother]]
    copy_global: List[np.ndarray]       # per level: global dof ids
    copy_level: List[np.ndarray]        # per level: level dof ids
    n_dofs: int
    coarse_tol: float = 1e-10
    coarse_maxiter: int = 1000
    coarse_rtol: float = 0.0            # >0: relative floor (float32 runs)
    coarse_iterations: list = field(default_factory=list)

    def __post_init__(self):
        dev = self.matrices[0].data.device
        idx = lambda a: upload(np.asarray(a, np.int64), dev)
        self._copies = [(idx(g), idx(c)) for g, c in zip(self.copy_global,
                                                         self.copy_level)]

    @spanned("solve.coarse")
    def _coarse_solve(self, d0):
        tol = self.coarse_tol
        if self.coarse_rtol > 0.0:
            tol = max(tol, self.coarse_rtol * host_float(
                torch.linalg.vector_norm(d0)))
        res = cg(self.matrices[0].matvec, d0, tol=tol,
                 maxiter=self.coarse_maxiter)
        self.coarse_iterations.append(res.iterations)
        return res.x

    def __call__(self, g: torch.Tensor) -> torch.Tensor:
        L = len(self.matrices) - 1
        defect = []
        for A, (gpos, lpos) in zip(self.matrices, self._copies):
            d = torch.zeros(A.n_rows, dtype=g.dtype, device=g.device)
            d[lpos] = g[gpos]
            defect.append(d)
        sol = [None] * (L + 1)
        for l in range(L, 0, -1):
            A, I = self.matrices[l], self.interfaces[l]
            u = self.smoothers[l].apply(defect[l])
            r = defect[l] - A.matvec(u)
            if I is not None:
                r = r - I.matvec(u)
            defect[l - 1] = defect[l - 1] + self.prolongations[l].matvec_T(r)
            sol[l] = u
        sol[0] = self._coarse_solve(defect[0])
        for l in range(1, L + 1):
            u = sol[l] + self.prolongations[l].matvec(sol[l - 1])
            I = self.interfaces[l]
            d = defect[l]
            if I is not None:
                d = d - I.matvec_T(u)
            sol[l] = self.smoothers[l].smooth(u, d)
        out = torch.zeros(self.n_dofs, dtype=g.dtype, device=g.device)
        for l, (gpos, lpos) in enumerate(self._copies):
            out[gpos] = sol[l][lpos]
        return out


def _level_signature(forest: Forest, ld: LevelDofs) -> tuple:
    """Content key for level-operator caching: the level matrix, interface
    matrix and smoother depend only on the level mesh and its constrained
    sets, not on which level cells are active, so levels stop changing once
    refinement moves past them.  Hashes level-local node coordinates
    (finest-lattice coordinates shifted down by max_level - level), which
    stay put when refinement deepens the tree."""
    import hashlib
    ld = ld.host
    coords = forest.nkey_to_coords(ld.keys, ld.degree)
    coords = coords >> (forest.max_level - ld.level)
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(coords))
    h.update(np.ascontiguousarray(ld.interface))
    return (ld.level, ld.n_dofs, len(ld.cell2dof), h.hexdigest())


@spanned("mg.levels")
def build_gmg(forest: Forest, dofs: DofInfo, tables,
              coeff_fn: Optional[Callable] = None, smoother: str = "ssor",
              smoother_damping: float = 0.5, smoother_steps: int = 2,
              coarse_tol: float = 1e-10, coarse_maxiter: int = 1000,
              dtype: torch.dtype = torch.float64, jacobi_damping: float = 0.6,
              coarse_rtol: float = 0.0, cache: Optional[dict] = None,
              device="cpu") -> GMGPreconditioner:
    """Assemble every level on ``device`` and wire the V-cycle there.

    coeff_fn: points (m, dim) tensor -> coefficient tensor, or None for unit
    coefficient.  cache: optional dict carried across adaptive cycles;
    unchanged levels reuse their matrices, smoothers and prolongations.
    smoother "none" builds no smoothers (the TpuGMG path makes its own)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device(device)
    levels_d = dofs.levels           # the level matrices: on ``device``
    dofs = dofs.host                 # the rest: on the host
    matrices, interfaces, prolongs, smoothers = [], [], [], []
    copy_global, copy_level = [], []
    sigs = [_level_signature(forest, ld) if cache is not None else None
            for ld in dofs.levels]

    for l, ld in enumerate(dofs.levels):
        level_ijk, active_index = forest.level_cells_host[l]
        ck = (("lvl", sigs[l], sigs[l - 1] if l > 0 else None)
              if cache is not None else None)
        if ck is not None and ck in cache:
            A, iface, P, smth = cache[ck]
        else:
            h = torch.full((len(level_ijk),), float(forest.h(l)),
                           dtype=torch.float64, device=dev)
            coeff_q = None
            if coeff_fn is not None:
                lower = forest.lower + forest.h(l) * level_ijk
                pts = (lower[:, None, :]
                       + forest.h(l) * tables.points[None, :, :])
                coeff_q = coeff_fn(torch.from_numpy(pts)).numpy()
            k = card.cell_matrices(tables, h, coeff_q, dtype)
            c2d, edge, bnd = (levels_d[l].cell2dof.to(dev),
                              levels_d[l].interface.to(dev),
                              levels_d[l].boundary.to(dev))
            A = level_matrix(c2d, edge, bnd, k, dtype)
            iface = None
            if l > 0 and ld.interface.any():
                # only cells touching a refinement-edge dof contribute
                # surviving (edge-row) entries
                sel = torch.nonzero(edge[c2d].any(1)).squeeze(1)
                iface = build_interface_csr(c2d[sel], edge, bnd, k.take(sel),
                                            dtype)
            P = (build_prolongation(forest, dofs, l, np_dtype, device)
                 if l > 0 else None)
            smth = None
            if l > 0 and smoother != "none":
                if smoother == "ssor":
                    pre = make_ssor(A, smoother_damping)
                elif smoother == "mc_ssor":
                    pre = make_mc_ssor(A, lattice_color(forest, ld),
                                       smoother_damping)
                elif smoother == "chebyshev":
                    pre = make_chebyshev(A)
                else:
                    pre = make_jacobi(A, jacobi_damping)
                smth = MGSmoother(A=A, precond=pre, steps=smoother_steps)
            if ck is not None:
                cache[ck] = (A, iface, P, smth)
        matrices.append(A)
        interfaces.append(iface)
        prolongs.append(P)
        smoothers.append(smth)

        # copy indices: dofs on ACTIVE level-l cells minus the refinement
        # edge (they depend on the active set: rebuilt every cycle)
        act = active_index >= 0
        ldofs = np.unique(ld.cell2dof[act])
        ldofs = ldofs[~ld.interface[ldofs]]
        copy_global.append(np.searchsorted(dofs.keys, ld.keys[ldofs]))
        copy_level.append(ldofs)

    return GMGPreconditioner(matrices=matrices, interfaces=interfaces,
                             prolongations=prolongs, smoothers=smoothers,
                             copy_global=copy_global, copy_level=copy_level,
                             n_dofs=dofs.n_dofs, coarse_tol=coarse_tol,
                             coarse_maxiter=coarse_maxiter,
                             coarse_rtol=coarse_rtol)
