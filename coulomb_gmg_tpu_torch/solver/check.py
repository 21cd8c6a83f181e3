"""The Solve's check on the device that holds the system.

Counterpart of the solve's closing lines of coulomb_gmg_tpu/driver.py (the
reference's src/step-50.cc:1008-1016): after each GMG-CG the true residual
``||b - A x||``, the l1, l2 and max norms of b and x, the system matrix's
norms (max column and row sums of ``|a|``, Frobenius) where there is an
assembled matrix, and ``ConstraintMatrix::distribute`` of the solution.

:func:`card_check` computes all of it in float64 where b and x lie, packs
the scalars and the distributed solution into one buffer and reads it back
once (``solver/cg.py:host_array``, one of the run's ``host_reads``).  The
matrix norms and the distribution are the hand kernels of
``csrc/solve_check.cu`` on a card (:func:`matrix_norms`,
:func:`distribute_rows`) and their plain versions on CPU tensors, the same
arithmetic in the same order but for the Frobenius norm's sum.  Each check counts one
``check_card_calls`` and runs in a span ``check.card``.  The host
``fem/constraints.py:distribute`` stays the definition that the tests hold
:func:`distribute_rows` to.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.dofs import Constraints
from coulomb_gmg_tpu_torch.ops.ell import Slices, ell_mv
from coulomb_gmg_tpu_torch.solver.cg import host_array
from coulomb_gmg_tpu_torch.utils.timer import count, span

_F64 = torch.float64
_THREADS = 256           # csrc/solve_check.cu:kThreads
_SIGS = {"matrix_norms_f64": [ctypes.c_void_p] * 3
         + [ctypes.c_longlong] + [ctypes.c_void_p] * 3,
         "distribute_rows_f64": [ctypes.c_void_p] * 7
         + [ctypes.c_longlong, ctypes.c_void_p]}

# the scalars at the head of the read-back buffer, in order
_HEAD = ("residual", "l1_rhs", "l2_rhs", "linf_rhs", "l1_sol", "l2_sol",
         "linf_sol", "l1_mat", "linf_mat", "fro_mat", "missing")
_MAT = ("l1_mat", "linf_mat", "fro_mat")
_NORMS = _HEAD[1:4] + _MAT + _HEAD[4:7]      # the driver's order


class Check(NamedTuple):
    residual: Optional[float]      # None where neither system nor defect
    norms: dict                    # l1/l2/linf of b ("_rhs") and x ("_sol");
                                   # l1/linf/fro "_mat" or None
    solution: np.ndarray           # x with its constrained rows distributed


def card_check(b: torch.Tensor, x: torch.Tensor, constraints: Constraints,
               system=None, defect: Optional[torch.Tensor] = None) -> Check:
    """The check of the solution ``x`` of ``A x = b`` (float64 tensors of
    the n DoFs on one device).  ``system``: the assembled matrix as its
    sliced ELL ``(Slices, vals)`` in float64, whose product gives the true
    residual and whose values the matrix norms; else ``defect``, a tensor
    whose norm is the true residual (the device operators' float64
    defect), or neither (the residual is known).  The constraint CSR goes
    up in two copies; one read brings everything back."""
    with span("check.card"):
        count("check_card_calls")
        dev, n = x.device, len(x)
        if b.device != dev or len(b) != n:
            raise ValueError(f"card_check: b {tuple(b.shape)} on {b.device}, "
                             f"x {tuple(x.shape)} on {dev}")
        b, x = b.to(_F64), x.to(_F64).contiguous()
        out = torch.empty(len(_HEAD) + n, dtype=_F64, device=dev)
        head, sol = out[: len(_HEAD)], out[len(_HEAD):]
        head.fill_(float("nan"))
        if system is not None:
            r = ell_mv(*system, x)
            defect = r.neg_().add_(b)
            matrix_norms(*system, head[7:])         # l1/linf/fro, missing
        if defect is not None:
            head[0] = torch.linalg.vector_norm(defect)
        del defect
        # the "_rhs" and "_sol" norms
        head[1:7] = torch.stack([torch.linalg.vector_norm(v, p)
                                 for v in (b, x)
                                 for p in (1, 2, float("inf"))])
        sol.copy_(x)
        ints, floats = _constraint_operands(constraints, dev)
        distribute_rows(ints, floats, len(constraints.rows), x, sol)
        host = host_array(out)
    vals = dict(zip(_HEAD, (float(v) for v in host[: len(_HEAD)])))
    if vals["missing"] > 0:
        raise ValueError(f"card_check: {int(vals['missing'])} entries of the "
                         f"system have no mirror: the pattern is not "
                         f"symmetric")
    norms = {k: vals[k] if k not in _MAT or system is not None else None
             for k in _NORMS}
    residual = vals["residual"]
    return Check(None if np.isnan(residual) else residual, norms,
                 host[len(_HEAD):])


def _constraint_operands(con: Constraints, dev):
    """``rows, indptr, cols`` as one int32 tensor and ``weights,
    inhomog`` as one float64 tensor on ``dev`` (two counted uploads)."""
    ints = np.concatenate([con.rows, con.indptr, con.cols]).astype(np.int32)
    floats = np.concatenate([con.weights, con.inhomog]).astype(np.float64)
    return upload(ints, dev), upload(floats, dev)


def _split(ints, floats, n_con):
    rows, indptr = ints[:n_con], ints[n_con: 2 * n_con + 1]
    nnz = len(ints) - 2 * n_con - 1
    return rows, indptr, ints[2 * n_con + 1:], floats[:nnz], floats[nnz:]


# ------------------------------------------------------------ the kernels

def matrix_norms(sl: Slices, vals: torch.Tensor, out: torch.Tensor) -> None:
    """``out[:4]`` = (max column sum of ``|a|``, max row sum, Frobenius norm,
    entries without a mirror) of the float64 sliced ELL ``(sl, vals)`` of
    a matrix with a symmetric pattern.  The hand kernel on a card, the
    plain version on CPU tensors: the same bits, but for the Frobenius
    norm, which each sums in its own order."""
    if vals.dtype != _F64 or out.dtype != _F64:
        raise TypeError(f"matrix_norms: float64 values and output, got "
                        f"{vals.dtype}/{out.dtype}")
    if vals.device.type == "cpu":
        out[:4] = matrix_norms_plain(sl, vals)
        return
    if sl.cols.dtype != torch.int32 or sl.off.dtype != torch.int64:
        raise TypeError("matrix_norms: int32 columns and int64 offsets")
    if not (sl.off.is_contiguous() and sl.cols.is_contiguous()
            and vals.is_contiguous() and out.is_contiguous()):
        raise ValueError("matrix_norms: operands must be contiguous")
    if len({t.device for t in (sl.off, sl.cols, vals, out)}) != 1:
        raise ValueError("matrix_norms: every operand must be on one card")
    blocks = -(-sl.n_rows // _THREADS)
    partial = torch.empty(4 * max(blocks, 1), dtype=_F64, device=vals.device)
    lib = kernels.library("solve_check", _SIGS)
    kernels.launch(lib.matrix_norms_f64, vals.device, "matrix_norms",
                   sl.off.data_ptr(), sl.cols.data_ptr(), vals.data_ptr(),
                   sl.n_rows, partial.data_ptr(), out.data_ptr())
    matrix_norms.launches += 1


matrix_norms.launches = 0


def matrix_norms_plain(sl: Slices, vals: torch.Tensor) -> torch.Tensor:
    """The kernel's column and row sums in torch: each row's over its slots
    in order, each column's over its mirrors (found by key) in ascending
    row order; the Frobenius norm of the values."""
    n = sl.n_rows
    cols, v = sl.padded(vals)                      # (width, n)
    cols = cols.long()
    k = torch.arange(cols.shape[0])[:, None]
    real = (k == 0) | (cols != 0)     # a row's columns ascend: pads are 0
    rows = torch.arange(n).expand_as(cols)
    keys = (rows * n + cols).T[real.T]             # CSR order: ascending
    kvals = v.T[real.T]
    want = cols * n + rows
    at = torch.searchsorted(keys, want).clamp(max=max(len(keys) - 1, 0))
    found = real & (keys[at] == want) & (cols < n)
    a = v.abs()
    rs, cs = torch.zeros(n, dtype=_F64), torch.zeros(n, dtype=_F64)
    for j in range(cols.shape[0]):
        rs = rs + a[j]
        cs = cs + torch.where(found[j], kvals[at[j]].abs(), 0.0)
    missing = float((real & ~found).sum())
    zero = torch.zeros(1, dtype=_F64)
    return torch.stack([torch.cat([cs, zero]).max(),
                        torch.cat([rs, zero]).max(),
                        torch.sqrt((a * a).sum()),
                        torch.tensor(missing, dtype=_F64)])


def distribute_rows(ints: torch.Tensor, floats: torch.Tensor, n_con: int,
                    x: torch.Tensor, out: torch.Tensor) -> None:
    """``out[rows[k]] = inhomog[k] + sum_e w[e] x[cols[e]]`` over the
    constraint CSR packed by :func:`_constraint_operands`; ``out`` holds a
    copy of ``x`` (float64) and keeps every other row.  The hand kernel on
    a card, the plain version on CPU tensors; the same bits."""
    if x.dtype != _F64 or out.dtype != _F64 or floats.dtype != _F64:
        raise TypeError("distribute_rows: float64 weights, x and output")
    if x.device.type == "cpu":
        distribute_rows_plain(ints, floats, n_con, x, out)
        return
    if ints.dtype != torch.int32:
        raise TypeError("distribute_rows: int32 rows, offsets and columns")
    if not all(t.is_contiguous() for t in (ints, floats, x, out)):
        raise ValueError("distribute_rows: operands must be contiguous")
    if len({t.device for t in (ints, floats, x, out)}) != 1:
        raise ValueError("distribute_rows: every operand must be on one card")
    if n_con == 0:
        return
    rows, indptr, cols, w, g = _split(ints, floats, n_con)
    lib = kernels.library("solve_check", _SIGS)
    kernels.launch(lib.distribute_rows_f64, x.device, "distribute_rows",
                   rows.data_ptr(), indptr.data_ptr(), cols.data_ptr(),
                   w.data_ptr(), g.data_ptr(), x.data_ptr(), out.data_ptr(),
                   n_con)
    distribute_rows.launches += 1


distribute_rows.launches = 0


def distribute_rows_plain(ints, floats, n_con, x, out) -> None:
    """The kernel's arithmetic in torch: the k-th term of every row that
    has one added in turn to its sum, then the sum to the inhomogeneity."""
    rows, indptr, cols, w, g = _split(ints.long(), floats, n_con)
    start, counts = indptr[:-1], indptr[1:] - indptr[:-1]
    acc = torch.zeros(n_con, dtype=_F64)
    for k in range(int(counts.max()) if n_con else 0):
        has = counts > k
        e = torch.where(has, start + k, 0)
        acc = torch.where(has, acc + w[e] * x[cols[e]], acc)
    out[rows] = g + acc
