"""Affine constraints: hanging nodes + Dirichlet boundary values.

Replicates deal.II ``ConstraintMatrix`` semantics as used by the reference
(``src/step-50.cc:661-696``): hanging-node constraints are added first, then
``interpolate_boundary_values`` adds Dirichlet rows only for dofs not already
constrained; ``close()`` resolves constraint chains so every resolved column
is unconstrained and boundary inhomogeneities are folded in.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from coulomb_gmg_tpu_torch.mesh.dofs import Constraints, DofInfo


def build_constraints(dofs: DofInfo,
                      boundary_fn: Optional[Callable] = None,
                      include_boundary: bool = True) -> Constraints:
    """Build the closed constraint set.

    boundary_fn: positions (m, dim) -> values (m,); None = homogeneous.
    include_boundary=False gives hanging-node-only constraints (the
    reference's separate ``hanging_node_constraints`` object).
    """
    dofs = dofs.host                 # one host copy of the DoF arrays
    n = dofs.n_dofs
    h_rows, h_cols, h_w = dofs.hanging_pairs

    hanging_set = np.unique(h_rows)
    is_hanging = np.zeros(n, dtype=bool)
    is_hanging[hanging_set] = True

    if include_boundary:
        b_rows = np.where(dofs.boundary & ~is_hanging)[0]
        if boundary_fn is None:
            b_vals = np.zeros(len(b_rows))
        else:
            b_vals = np.asarray(boundary_fn(dofs.positions[b_rows]),
                                dtype=np.float64)
    else:
        b_rows = np.zeros(0, dtype=np.int64)
        b_vals = np.zeros(0)

    is_dirichlet = np.zeros(n, dtype=bool)
    is_dirichlet[b_rows] = True
    dirichlet_value = np.zeros(n)
    dirichlet_value[b_rows] = b_vals

    # --- resolve hanging chains: replace constrained columns until all
    # remaining columns are unconstrained.  Hanging->hanging chains strictly
    # decrease level, so this terminates.
    rows = h_rows.copy()
    cols = h_cols.copy()
    wts = h_w.copy()
    inhomog = np.zeros(n)      # accumulated per constrained row

    for _ in range(64):
        col_is_d = is_dirichlet[cols]
        if col_is_d.any():
            np.add.at(inhomog, rows[col_is_d],
                      wts[col_is_d] * dirichlet_value[cols[col_is_d]])
            rows, cols, wts = rows[~col_is_d], cols[~col_is_d], wts[~col_is_d]
        col_is_h = is_hanging[cols]
        if not col_is_h.any():
            break
        # expand hanging columns through the raw hanging table
        keep = ~col_is_h
        er, ec, ew = rows[col_is_h], cols[col_is_h], wts[col_is_h]
        # join ec against h_rows: for each expansion col, its entries
        order = np.argsort(h_rows, kind="stable")
        hr_s, hc_s, hw_s = h_rows[order], h_cols[order], h_w[order]
        starts = np.searchsorted(hr_s, ec, side="left")
        ends = np.searchsorted(hr_s, ec, side="right")
        counts = ends - starts
        rep_rows = np.repeat(er, counts)
        rep_w = np.repeat(ew, counts)
        take = _ragged_take(starts, counts)
        new_cols = hc_s[take]
        new_w = rep_w * hw_s[take]
        rows = np.concatenate([rows[keep], rep_rows])
        cols = np.concatenate([cols[keep], new_cols])
        wts = np.concatenate([wts[keep], new_w])
    else:
        raise RuntimeError("hanging-node constraint chain did not resolve")

    # merge duplicate (row, col) pairs
    if len(rows):
        pair = rows * np.int64(n) + cols
        uniq, inv = np.unique(pair, return_inverse=True)
        merged_w = np.zeros(len(uniq))
        np.add.at(merged_w, inv, wts)
        rows = (uniq // n).astype(np.int64)
        cols = (uniq % n).astype(np.int64)
        wts = merged_w

    # assemble final CSR over sorted constrained rows
    all_rows = np.union1d(hanging_set, b_rows).astype(np.int64)
    row_pos = {r: i for i, r in enumerate(all_rows)}
    counts = np.zeros(len(all_rows), dtype=np.int64)
    if len(rows):
        ridx = np.searchsorted(all_rows, rows)
        np.add.at(counts, ridx, 1)
    indptr = np.zeros(len(all_rows) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    out_cols = np.zeros(indptr[-1], dtype=np.int64)
    out_w = np.zeros(indptr[-1])
    if len(rows):
        order = np.lexsort([cols, rows])
        out_cols[:] = cols[order]
        out_w[:] = wts[order]
    g = np.zeros(len(all_rows))
    g[np.searchsorted(all_rows, hanging_set)] = inhomog[hanging_set]
    if len(b_rows):
        g[np.searchsorted(all_rows, np.sort(b_rows))] = \
            dirichlet_value[np.sort(b_rows)]
    return Constraints(rows=all_rows, indptr=indptr, cols=out_cols,
                       weights=out_w, inhomog=g, n_dofs=n)


def _ragged_take(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Indices [starts[i] .. starts[i]+counts[i]) concatenated."""
    total = int(counts.sum())
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0] if len(starts) else 0
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1]) + 1
    return np.cumsum(out)


def distribute(constraints: Constraints, x: np.ndarray) -> np.ndarray:
    """``ConstraintMatrix::distribute``: overwrite constrained entries with
    their resolved values (src/step-50.cc:1016)."""
    x = np.asarray(x).copy()
    vals = constraints.inhomog.copy()
    for k in range(len(constraints.rows)):
        s, e = constraints.indptr[k], constraints.indptr[k + 1]
        vals[k] += np.dot(constraints.weights[s:e], x[constraints.cols[s:e]])
    x[constraints.rows] = vals
    return x


def set_zero(constraints: Constraints, x: np.ndarray) -> np.ndarray:
    """``ConstraintMatrix::set_zero`` (src/step-50.cc:1119)."""
    x = np.asarray(x).copy()
    x[constraints.rows] = 0.0
    return x
