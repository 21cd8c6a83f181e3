"""Chebyshev-Jacobi preconditioned CG on the ELL kernel.

Counterpart of coulomb_gmg_tpu/solver/tpu_cg.py (``tpu_cg_solve``, the
solve of ``preconditioner="Jacobi"`` in float32 runs, one jit there,
``_cheby_cg_coo``): lambda_max of D^{-1} A by 12 power-iteration steps on
the device, a degree-4 Chebyshev preconditioner on [lmax / 30, lmax]
(ops/smoothers.py:chebyshev), and the CG of solver/cg.py on the system's
transposed ELL.  ``fused=True`` (the driver's ``solve_fused``) runs it as
:class:`SteppedChebyCG`, on the card CUDA graphs (solver/fused.py);
``fused=False`` the eager loop of solver/cg.py.  The TPU module's pow2
buckets of rows, K and nonzeros kept one compiled executable across
adaptive cycles; they have no counterpart (one dead row remains, for the
padded vectors).
"""

from __future__ import annotations

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import ELL, ell_mv
from coulomb_gmg_tpu_torch.ops.smoothers import chebyshev
from coulomb_gmg_tpu_torch.solver.cg import CGResult, cg, to_host
from coulomb_gmg_tpu_torch.solver.fused import Segments

POWER_STEPS = 12


def _lmax(matvec, inv_diag, like: torch.Tensor) -> torch.Tensor:
    """1.1 lambda_max(D^{-1} A) by power iteration from ones (device)."""
    v = torch.ones_like(like)
    for _ in range(POWER_STEPS):
        w = inv_diag * matvec(v)
        v = w / torch.linalg.vector_norm(w)
    return torch.dot(v, inv_diag * matvec(v)) * 1.1


def _cheby_cg(ecols, evals, rhs, x0, inv_diag, tol: float, maxiter: int):
    def matvec(v):
        return ell_mv(ecols, evals, v)

    lmax = _lmax(matvec, inv_diag, rhs)
    return cg(matvec, rhs, x0, precond=chebyshev(matvec, inv_diag, lmax),
              tol=tol, maxiter=maxiter)


class SteppedChebyCG:
    """``_cheby_cg`` as device state and two segments (solver/fused.py):
    ``start`` holds the power steps and the initial residual, ``step`` one
    iteration of solver/cg.py:cg with its own stopping test (``res < tol``
    after the update, a float32 norm against the float64 ``tol``).  The
    iteration is rotated so that it begins with the preconditioner:
    ``p = z`` on the first step, ``z + beta p`` after, which is the eager
    loop's order of operations.  Host reads per solve: ``k + 1``, as the
    eager loop's."""

    def __init__(self, ecols, evals, inv_diag, device):
        dev = torch.device(device)
        dtype = evals.dtype
        self.cols, self.vals, self.inv_diag = ecols, evals, inv_diag
        n = inv_diag.shape[0]
        self.rhs, self.x, self.r, self.p = (
            torch.zeros(n, dtype=dtype, device=dev) for _ in range(4))
        self.rho, self.res, self.res0, self.lmax = (
            torch.zeros((), dtype=dtype, device=dev) for _ in range(4))
        self.tol = torch.zeros((), dtype=torch.float64, device=dev)
        self.k, self.maxiter = (torch.zeros((), dtype=torch.int32, device=dev)
                                for _ in range(2))
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.info = torch.zeros(4, dtype=torch.float64, device=dev)
        self.segments = Segments({"start": self._start, "step": self._step},
                                 dev)

    def _mv(self, v: torch.Tensor) -> torch.Tensor:
        return ell_mv(self.cols, self.vals, v)

    def solve(self, rhs, x0, tol: float, maxiter: int) -> CGResult:
        self.segments.prepare()
        self.rhs.copy_(rhs)
        self.x.copy_(x0)
        self.tol.fill_(tol)
        self.maxiter.fill_(maxiter)
        self.segments.run("start")
        while True:
            active, k, res0, res = to_host(self.info)
            if not active:
                break
            self.segments.run("step")
        return CGResult(x=self.x.clone(), iterations=int(k),
                        initial_residual=res0, final_residual=res)

    def release(self) -> None:
        self.segments.release()

    def _start(self) -> None:
        self.lmax.copy_(_lmax(self._mv, self.inv_diag, self.rhs))
        r = self.rhs - self._mv(self.x)
        res = torch.linalg.vector_norm(r)
        self.r.copy_(r)
        self.res.copy_(res)
        self.res0.copy_(res)
        self.k.zero_()
        self.active.copy_(res.double() >= self.tol)
        self._info()

    def _step(self) -> None:
        z = chebyshev(self._mv, self.inv_diag, self.lmax)(self.r)
        rho = torch.dot(self.r, z)
        p = torch.where(self.k == 0, z, z + (rho / self.rho) * self.p)
        q = self._mv(p)
        alpha = rho / torch.dot(p, q)
        self.x.copy_(self.x + alpha * p)
        r = self.r - alpha * q
        self.r.copy_(r)
        self.p.copy_(p)
        self.rho.copy_(rho)
        self.res.copy_(torch.linalg.vector_norm(r))
        self.k.add_(1)
        self.active.copy_(~(self.res.double() < self.tol)
                          & (self.k < self.maxiter))
        self._info()

    def _info(self) -> None:
        self.info.copy_(torch.stack([self.active.double(), self.k.double(),
                                     self.res0.double(), self.res.double()]))


def tpu_cg_solve(rowids, cols, data, rhs, x0=None, *, diag=None,
                 rtol: float = 1e-6, maxiter: int = 2000, device="cuda",
                 dtype: torch.dtype = torch.float32, fused: bool = True):
    """Chebyshev-CG solve of the COO system (rowids, cols, data); numpy in,
    numpy out: (x, iterations, |r0|, |r|), tol = rtol * |rhs|.  With
    ``fused``, the stepped solve (its graphs captured for this system and
    released at the end)."""
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
    to_dev = lambda a: torch.from_numpy(a).to(dev)
    if fused:
        stepped = SteppedChebyCG(ecols, evals, to_dev(inv_diag), dev)
        try:
            res = stepped.solve(to_dev(b), to_dev(x), tol, maxiter)
        finally:
            stepped.release()
    else:
        res = _cheby_cg(ecols, evals, to_dev(b), to_dev(x),
                        to_dev(inv_diag), tol, maxiter)
    return (res.x[:n].cpu().numpy(), res.iterations, res.initial_residual,
            res.final_residual)
