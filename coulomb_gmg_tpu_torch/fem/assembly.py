"""Constraint-aware sparse assembly.

Counterpart of coulomb_gmg_tpu/fem/assembly.py, which imports jax at the
top, so the port carries its own copy of the host code: the reference's
cell loop + ``ConstraintMatrix::distribute_local_to_global`` + Trilinos
``compress`` (``src/step-50.cc:735-833``) as

* **plan (host, per topology):** every (cell, local dof) resolved into its
  constraint expansion, the global CSR pattern and flat scatter maps; clean
  cells (no constrained dof) are never materialized as scatter triples,
  their cross products are generated inside the native pattern engine
  (``csrc/forest_engine.cpp:cgmg_pattern``);
* **execute:** batched element tensors and two scatter-adds on the host
  (:func:`assemble_np`, as in the JAX driver: the studies and the tests'
  reference); the sharded assembly (parallel/spmd.py) sums the same plan's
  entries on the shards' devices by gather (:func:`gather_sum`).

The single-device driver builds its matrices on the device instead
(fem/card_assembly.py), with the same order of entries.

deal.II semantics exactly:
- unconstrained (i, j): ``K[I,J] += k_ij``;
- constrained rows/cols distributed with resolved weights;
- for each constrained local dof i: ``K[I,I] += k_ii`` (regularization
  diagonal) and ``rhs[I] += k_ii * g_i``;
- rhs lift ``rhs -= K_cell @ g_local`` for inhomogeneous constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from coulomb_gmg_tpu_torch.mesh.dofs import Constraints

GATHER_WIDTH = 8      # entries of one target summed per gather_sum round


@dataclass
class CSRPattern:
    n_rows: int
    indptr: np.ndarray
    indices: np.ndarray

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def pos_of(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """CSR data positions of (row, col) pairs (must exist): vectorized
        per-segment binary search (indices sorted within each row)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        lo = self.indptr[rows].copy()
        hi = self.indptr[rows + 1].copy()
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) // 2
            v = self.indices[np.where(active, mid, 0)]
            go_right = active & (v < cols)
            lo = np.where(go_right, mid + 1, lo)
            hi = np.where(active & ~go_right, mid, hi)
        assert (self.indices[lo] == cols).all(), "pattern missing entry"
        return lo


@dataclass
class AssemblyPlan:
    """Precomputed scatter maps for one mesh topology + constraint set.

    Matrix-entry enumeration order (shared with the pattern engine):
    the clean cells' (cell, i, j) cross products in canonical order —
    exactly ``k_cells[clean_idx].reshape(-1)`` — followed by the dirty
    cells' constraint-expanded entries (md_*)."""

    pattern: CSRPattern
    n_cells: int
    n_basis: int
    # clean cells (identity constraint expansion)
    clean_idx: np.ndarray        # (nc,) global cell ids
    r_dof_clean: np.ndarray      # (nc*nb,) = cell2dof[clean_idx].ravel()
    # data position of every enumerated matrix entry (clean then dirty)
    m_pos: np.ndarray
    # dirty matrix entries: value = w * K_cell[cell, i, j]
    md_cell: np.ndarray          # global cell ids
    md_i: np.ndarray
    md_j: np.ndarray
    md_w: np.ndarray
    # constrained-diagonal entries: data[pos] += K_cell[cell, i, i];
    # rhs[dof] += K_cell[cell, i, i] * g
    d_cell: np.ndarray           # global cell ids
    d_i: np.ndarray
    d_pos: np.ndarray
    d_dof: np.ndarray
    d_g: np.ndarray
    # dirty rhs scatter: rhs[dof] += w * f_eff[rd_cell(local), i]
    dirty_idx: np.ndarray        # (nd,) global cell ids
    rd_cell: np.ndarray          # DIRTY-LOCAL cell index
    rd_i: np.ndarray
    rd_w: np.ndarray
    rd_dof: np.ndarray
    # local inhomogeneity (nd, nb) for the lift term (dirty cells only)
    gd_local: np.ndarray


def _ragged_cross(offsets: np.ndarray):
    """For segments [offsets[c], offsets[c+1]), return index arrays (a, b)
    enumerating the cartesian product within each segment (a-major, b-minor
    within each segment).

    Pure repeat/cumsum arithmetic — no per-pair integer division (the
    obvious ``local // k`` / ``local % k`` construction spends ~60% of the
    build_plan dirty-cell expansion in int64 division at production scale).
    """
    counts = np.diff(offsets)
    if len(counts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    n_elem = int(offsets[-1])
    # each element e of segment c is the LEFT side of k_c pairs
    k_of_elem = np.repeat(counts, counts)                     # (n_elem,)
    a = np.repeat(np.arange(n_elem, dtype=np.int64), k_of_elem)
    total = len(a)
    # right side: segment base + position of the pair within e's block
    pair_start = np.zeros(n_elem + 1, dtype=np.int64)
    np.cumsum(k_of_elem, out=pair_start[1:])
    local_j = np.arange(total, dtype=np.int64) - np.repeat(
        pair_start[:-1], k_of_elem)
    seg_base = np.repeat(offsets[:-1], counts)                # (n_elem,)
    b = np.repeat(seg_base, k_of_elem) + local_j
    return a, b


def _expand_entries(cell2dof: np.ndarray, crow: np.ndarray,
                    constraints: Constraints):
    """Constraint expansion of the given (dirty) cells.

    cell2dof: (nd, nb) global dof ids; crow: (nd, nb) constraint row index
    or -1.  Cell indices in the returned arrays are LOCAL (0..nd-1).
    Returns (m_cell, m_i, m_j, m_w, m_row, m_col,
             d_cell, d_i, d_dof, d_g, r_cell, r_i, r_w, r_dof, g_local).
    """
    nd, n_basis = cell2dof.shape
    is_con = crow >= 0
    row_sizes = np.diff(constraints.indptr)
    if len(row_sizes) == 0:
        row_sizes = np.zeros(1, dtype=np.int64)
    counts = np.where(is_con, row_sizes[np.clip(crow, 0, None)],
                      1).astype(np.int64)
    flat_counts = counts.reshape(-1)
    exp_off = np.zeros(nd * n_basis + 1, dtype=np.int64)
    np.cumsum(flat_counts, out=exp_off[1:])
    total = int(exp_off[-1])
    exp_dof = np.empty(total, dtype=np.int64)
    exp_w = np.empty(total)
    exp_cell = np.repeat(np.arange(nd), n_basis)
    exp_cell = np.repeat(exp_cell, flat_counts)
    exp_i = np.tile(np.arange(n_basis), nd)
    exp_i = np.repeat(exp_i, flat_counts)

    flat_dof = cell2dof.reshape(-1)
    flat_crow = crow.reshape(-1)
    uncon = flat_crow < 0
    upos = exp_off[:-1][uncon]
    exp_dof[upos] = flat_dof[uncon]
    exp_w[upos] = 1.0
    con_idx = np.where(~uncon)[0]
    if len(con_idx):
        src_start = constraints.indptr[flat_crow[con_idx]]
        cnts = flat_counts[con_idx]
        dst_start = exp_off[:-1][con_idx]
        nz = cnts > 0
        if nz.any():
            inner = np.arange(int(cnts[nz].sum())) - np.repeat(
                np.concatenate([[0], np.cumsum(cnts[nz])[:-1]]), cnts[nz])
            src = np.repeat(src_start[nz], cnts[nz]) + inner
            dst = np.repeat(dst_start[nz], cnts[nz]) + inner
            exp_dof[dst] = constraints.cols[src]
            exp_w[dst] = constraints.weights[src]

    # matrix entries: cross product of expansions within each cell —
    # native threaded fill (one pass, disjoint writes) with a numpy
    # fallback (~6 gather passes over 8M+ entries at production scale)
    from coulomb_gmg_tpu_torch.utils import native
    cell_off = np.ascontiguousarray(exp_off[::n_basis])
    cg = native.cross_gather(cell_off, exp_i, np.asarray(exp_w, np.float64),
                             exp_dof)
    if cg is not None:
        m_cell, m_i, m_j, m_w, m_row, m_col = cg
    else:
        a, b = _ragged_cross(cell_off)
        m_cell = exp_cell[a]
        m_i = exp_i[a]
        m_j = exp_i[b]
        m_w = exp_w[a] * exp_w[b]
        m_row = exp_dof[a]
        m_col = exp_dof[b]

    # constrained diagonal entries
    d_sel = np.where(is_con.reshape(-1))[0]
    d_cell = d_sel // n_basis
    d_i = (d_sel % n_basis).astype(np.int64)
    d_dof = flat_dof[d_sel]
    d_g = constraints.inhomog[flat_crow[d_sel]]

    g_local = np.zeros((nd, n_basis))
    g_local.reshape(-1)[d_sel] = d_g

    return (m_cell, m_i, m_j, m_w, m_row, m_col, d_cell, d_i, d_dof, d_g,
            exp_cell, exp_i, exp_w, exp_dof, g_local)


def build_plan(cell2dof: np.ndarray, constraints: Constraints) -> AssemblyPlan:
    from coulomb_gmg_tpu_torch.mesh.forest import to_host
    from coulomb_gmg_tpu_torch.utils import native

    cell2dof = to_host(cell2dof)
    n_cells, n_basis = cell2dof.shape
    n = constraints.n_dofs
    crow = constraints.row_of(cell2dof.reshape(-1)).reshape(n_cells, n_basis)
    is_con = crow >= 0
    clean = ~is_con.any(axis=1)
    clean_idx = np.where(clean)[0]
    dirty_idx = np.where(~clean)[0]

    (m_cell, m_i, m_j, m_w, m_row, m_col, d_cell, d_i, d_dof, d_g,
     r_cell, r_i, r_w, r_dof, gd_local) = _expand_entries(
        cell2dof[dirty_idx], crow[dirty_idx], constraints)

    # pattern + inverse over: implicit clean pairs, dirty matrix pairs,
    # dirty regularization diagonals
    extra_rows = np.concatenate([m_row, d_dof])
    extra_cols = np.concatenate([m_col, d_dof])
    indptr, indices, inverse = native.pattern(
        cell2dof[clean_idx].reshape(len(clean_idx), n_basis),
        extra_rows, extra_cols, n)
    pattern = CSRPattern(n_rows=n, indptr=indptr, indices=indices)

    n_clean_m = len(clean_idx) * n_basis * n_basis
    n_dirty_m = len(m_cell)
    m_pos = inverse[: n_clean_m + n_dirty_m]
    d_pos = inverse[n_clean_m + n_dirty_m:]

    return AssemblyPlan(
        pattern=pattern, n_cells=n_cells, n_basis=n_basis,
        clean_idx=clean_idx,
        r_dof_clean=cell2dof[clean_idx].reshape(-1),
        m_pos=m_pos,
        md_cell=dirty_idx[m_cell], md_i=m_i, md_j=m_j, md_w=m_w,
        d_cell=dirty_idx[d_cell], d_i=d_i, d_pos=d_pos, d_dof=d_dof, d_g=d_g,
        dirty_idx=dirty_idx, rd_cell=r_cell, rd_i=r_i, rd_w=r_w,
        rd_dof=r_dof, gd_local=gd_local)


def assemble_np(plan: AssemblyPlan, k_cells, f_cells=None, dtype=np.float64):
    """Host (numpy) assembly: (data (nnz,), rhs (n,) or None).

    The clean-cell gather and the bincounts route
    through the threaded native engine (utils/native.py:scatter_add /
    gather_blocks) — np.bincount alone is 118M single-threaded adds per
    system matrix at 64k atoms.  The threaded sum reassociates float64
    additions at thread-slice boundaries (last-bit differences vs the
    sequential order); this is within the golden tolerances (norms pinned
    at 1e-6 relative, topology asserted exactly by the trajectory tests,
    which run against THIS path).
    """
    from coulomb_gmg_tpu_torch.utils import native

    nnz = plan.pattern.nnz
    n = plan.pattern.n_rows
    k_cells = np.asarray(k_cells, dtype=dtype)
    k64 = k_cells if k_cells.dtype == np.float64 \
        else k_cells.astype(np.float64)
    vals_clean = native.gather_blocks(k64, plan.clean_idx).reshape(-1)
    if len(plan.md_cell):
        vals_dirty = k64[plan.md_cell, plan.md_i, plan.md_j] * plan.md_w
        vals = np.concatenate([vals_clean, vals_dirty])
    else:
        vals = vals_clean
    data = np.zeros(nnz, np.float64)
    if len(vals):
        native.scatter_add(plan.m_pos, vals, nnz, out=data)
    if len(plan.d_pos):
        kdiag = k64[plan.d_cell, plan.d_i, plan.d_i]
        native.scatter_add(plan.d_pos, kdiag, nnz, out=data)
    data = data.astype(dtype, copy=False)

    rhs = None
    if f_cells is not None:
        f_cells = np.asarray(f_cells, np.float64)
        rhs = np.zeros(n, np.float64)
        if len(plan.r_dof_clean):
            native.scatter_add(
                plan.r_dof_clean,
                native.gather_blocks(f_cells, plan.clean_idx).reshape(-1),
                n, out=rhs)
        if len(plan.rd_dof):
            lift = np.einsum("cij,cj->ci", k64[plan.dirty_idx],
                             plan.gd_local)
            f_eff = f_cells[plan.dirty_idx] - lift
            rvals = f_eff[plan.rd_cell, plan.rd_i] * plan.rd_w
            native.scatter_add(plan.rd_dof, rvals, n, out=rhs)
        rhs = rhs.astype(dtype, copy=False)
        # deal.II ConstraintMatrix convention (verified against the golden
        # rhs norms): constrained rows get a ZERO rhs — the regularization
        # diagonal k_ii stays in the matrix, so CG yields x_i = 0 there and
        # constraints.distribute() writes the actual values afterwards.
    return data, rhs


def gather_sum(vals: torch.Tensor, pos: np.ndarray,
               n_out: int) -> torch.Tensor:
    """``zeros(n_out).index_add(0, pos, vals)`` as gathers, with the same
    order of additions on every run and device (no atomics).

    The entries are sorted by target (stably); each round sums runs of up
    to ``GATHER_WIDTH`` consecutive entries of one target through a
    (width, n_runs) gather table, until one value per target is left.  A
    target hit by at most ``GATHER_WIDTH`` entries is summed in one
    gather, in entry order; the few hit by many (constraint-expanded
    masters, up to ~200 entries) take a round per factor of
    ``GATHER_WIDTH`` instead of widening every target's table to
    theirs."""
    width = GATHER_WIDTH
    out = vals.new_zeros(n_out)
    if len(pos) == 0:
        return out
    dev = vals.device
    order = np.argsort(np.asarray(pos, np.int64), kind="stable")
    target = np.asarray(pos, np.int64)[order]
    v = vals[torch.from_numpy(order).to(dev)]
    while True:
        first = np.flatnonzero(np.r_[True, target[1:] != target[:-1]])
        counts = np.diff(np.r_[first, len(target)])
        local = np.arange(len(target)) - np.repeat(first, counts)
        starts = local % width == 0          # an entry that opens a run
        run = np.cumsum(starts) - 1
        table = np.full((min(width, int(counts.max())), int(run[-1]) + 1),
                        len(target), np.int64)
        table[local % width, run] = np.arange(len(target))
        v = torch.cat([v, v.new_zeros(1)])[torch.from_numpy(table).to(
            dev)].sum(0)
        target = target[starts]
        if counts.max() <= width:
            break
    out[torch.from_numpy(target).to(dev)] = v
    return out

