"""Chebyshev-Jacobi preconditioned CG on the ELL kernel.

Counterpart of coulomb_gmg_tpu/solver/tpu_cg.py (``tpu_cg_solve``, the
solve of ``preconditioner="Jacobi"`` in float32 runs): lambda_max of
D^{-1} A by 12 power-iteration steps on the device, a degree-4 Chebyshev
preconditioner on [lmax / 30, lmax] (ops/smoothers.py:chebyshev), and the
CG of solver/cg.py on the system's transposed ELL.  The
TPU module's pow2 buckets of rows, K and nonzeros kept one compiled
executable across adaptive cycles; they have no counterpart (one dead row
remains, for the padded vectors).
"""

from __future__ import annotations

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import ELL, ell_mv
from coulomb_gmg_tpu_torch.ops.smoothers import chebyshev
from coulomb_gmg_tpu_torch.solver.cg import cg


def _cheby_cg(ecols, evals, rhs, x0, inv_diag, tol: float, maxiter: int):
    def matvec(v):
        return ell_mv(ecols, evals, v)

    v = torch.ones_like(rhs)
    for _ in range(12):
        w = inv_diag * matvec(v)
        v = w / torch.linalg.vector_norm(w)
    lmax = torch.dot(v, inv_diag * matvec(v)) * 1.1
    return cg(matvec, rhs, x0, precond=chebyshev(matvec, inv_diag, lmax),
              tol=tol, maxiter=maxiter)


def tpu_cg_solve(rowids, cols, data, rhs, x0=None, *, diag=None,
                 rtol: float = 1e-6, maxiter: int = 2000, device="cuda",
                 dtype: torch.dtype = torch.float32):
    """Chebyshev-CG solve of the COO system (rowids, cols, data); numpy in,
    numpy out: (x, iterations, |r0|, |r|), tol = rtol * |rhs|."""
    dev = torch.device(device)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    n = len(rhs)
    n_pad = n + 1
    b = np.zeros(n_pad, np_dtype)
    b[:n] = np.asarray(rhs, np_dtype)
    x = np.zeros(n_pad, np_dtype)
    if x0 is not None:
        x[:n] = np.asarray(x0, np_dtype)
    diag_full = np.zeros(n_pad, np_dtype)
    if diag is None:
        sel = np.asarray(rowids) == np.asarray(cols)
        diag_full[np.asarray(rowids)[sel]] = np.asarray(data, np_dtype)[sel]
    else:
        diag_full[:n] = np.asarray(diag, np_dtype)
    diag_full[diag_full == 0] = 1.0
    inv_diag = (1.0 / diag_full).astype(np_dtype)
    tol = rtol * float(np.linalg.norm(b))
    e = ELL.from_coo(np.asarray(rowids), np.asarray(cols),
                     np.asarray(data, np_dtype), n, n, pad_rows_to=n_pad)
    ecols, evals = e.device(dev)
    put = lambda a: torch.from_numpy(a).to(dev)
    res = _cheby_cg(ecols, evals, put(b), put(x), put(inv_diag), tol,
                    maxiter)
    return (res.x[:n].cpu().numpy(), res.iterations, res.initial_residual,
            res.final_residual)
