"""Multigrid smoothers.

Counterpart of coulomb_gmg_tpu/ops/smoothers.py.  The reference smooths
with Trilinos ``PreconditionSSOR`` (damping 0.5, two steps,
src/step-50.cc:969-973), an inherently sequential sweep:

* ``ssor`` (:class:`HostSSOR`): exact sequential SSOR by sparse triangular
  solves in host scipy, float64, as the JAX package defines it: the
  reference's smoother and that of every golden.  Each application copies
  the defect to the host and the result back; the object counts the
  seconds of both;
* ``mc_ssor``: multicolour (2^dim colours) symmetric Gauss-Seidel, each
  colour's rows a sliced ELL block through the ELL kernel, written back by
  an indexed write over that colour's rows (unique, so no scatter over
  repeated indices);
* ``jacobi``: damped point Jacobi (src/step-50.cc:996-1005);
* ``chebyshev``: degree-k Chebyshev acceleration of Jacobi.

All are ``precond(r) -> z`` callables (approximate A^{-1}) on torch
tensors; :class:`MGSmoother` wraps them with the deal.II
``MGSmootherPrecondition`` stepping.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import SlicedELL, ell_mv


def make_jacobi(A, damping: float = 0.6):
    """Damped Jacobi preconditioner: z = damping * r / diag(A)."""
    inv_diag = damping / A.diagonal()

    def precond(r):
        return inv_diag * r
    return precond


class HostSSOR:
    """Exact sequential SSOR (one symmetric sweep, zero initial guess):

      forward  i asc : y_i += omega * (r_i - sum_j a_ij y_j) / a_ii
      backward i desc: y_i += omega * (r_i - sum_j a_ij y_j) / a_ii

    as triangular solves in host scipy, float64:
      y1 = (D/omega + L)^{-1} r
      y  = y1 + (D/omega + U)^{-1} (r - A y1)

    ``calls``, ``solve_s`` (host solves) and ``copy_s`` (the defect to the
    host and the result back, device work before it synchronized first)
    count its applications."""

    def __init__(self, A, omega: float = 0.5):
        import scipy.sparse as sp
        S = A.to_scipy().tocsr().astype(np.float64)
        D = S.diagonal()
        Dw = sp.diags(D / omega)
        self.S = S
        self.lower = (Dw + sp.tril(S, k=-1, format="csr")).tocsr()
        self.upper = (Dw + sp.triu(S, k=1, format="csr")).tocsr()
        self.calls = 0
        self.solve_s = 0.0
        self.copy_s = 0.0

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        import scipy.sparse.linalg as spla
        if r.is_cuda:
            torch.cuda.synchronize(r.device)
        t0 = time.perf_counter()
        rh = r.detach().cpu().numpy().astype(np.float64)
        t1 = time.perf_counter()
        y1 = spla.spsolve_triangular(self.lower, rh, lower=True)
        y = y1 + spla.spsolve_triangular(self.upper, rh - self.S @ y1,
                                         lower=False)
        t2 = time.perf_counter()
        out = torch.from_numpy(y).to(r.device, r.dtype)
        if r.is_cuda:
            torch.cuda.synchronize(r.device)
        self.copy_s += (t1 - t0) + (time.perf_counter() - t2)
        self.solve_s += t2 - t1
        self.calls += 1
        return out


def make_ssor_host(A, omega: float = 0.5) -> HostSSOR:
    return HostSSOR(A, omega)


def make_mc_ssor(A, color: np.ndarray, omega: float = 0.5):
    """Multicolour symmetric Gauss-Seidel: within a colour all updates are
    independent, so each half-sweep visits the colours in order with the
    update ``y_i += omega / a_ii * (r_i - A_i . y)`` on that colour's rows,
    read from a sliced per-colour ELL block (O(nnz) per half-sweep)."""
    color = np.asarray(color)
    n_colors = int(color.max()) + 1 if len(color) else 1
    diag = A.diagonal().detach().cpu().numpy()
    counts = np.diff(A.indptr)
    data = A.data_np()
    dev = A.data.device
    slices = []
    for c in range(n_colors):
        rows = np.where(color == c)[0]
        if len(rows) == 0:
            continue
        lens = counts[rows]
        src = (np.repeat(A.indptr[rows], lens)
               + np.arange(int(lens.sum()))
               - np.repeat(lens.cumsum() - lens, lens))
        e = SlicedELL.from_coo(np.repeat(np.arange(len(rows)), lens),
                               A.indices[src], data[src], len(rows))
        cols, vals = e.device(dev)
        w = torch.from_numpy(omega / diag[rows]).to(dev, A.data.dtype)
        slices.append((torch.from_numpy(rows).to(dev), cols, vals, w))

    def precond(r):
        y = torch.zeros_like(r)

        def upd(y, sl):
            rows, cols, vals, w = sl
            resid = r[rows] - ell_mv(cols, vals, y)
            return y.index_put((rows,), y[rows] + w * resid)

        for sl in slices:
            y = upd(y, sl)
        for sl in reversed(slices):
            y = upd(y, sl)
        return y
    return precond


def chebyshev(matvec, inv_diag, lambda_max, degree: int = 4,
              eig_ratio: float = 30.0):
    """Degree-k Chebyshev iteration for z ~ (D^{-1}A)^{-1} D^{-1} r on the
    spectrum [lambda_max / eig_ratio, lambda_max] of D^{-1}A
    (``lambda_max`` a float or a device scalar)."""
    lmin = lambda_max / eig_ratio
    theta = 0.5 * (lambda_max + lmin)
    delta = 0.5 * (lambda_max - lmin)

    def precond(r):
        rd = inv_diag * r
        z = rd / theta
        p = z
        sigma = theta / delta
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            resid = rd - inv_diag * matvec(z)
            rho = 1.0 / (2.0 * sigma - rho_old)
            p = rho * rho_old * p + (2.0 * rho / delta) * resid
            z = z + p
            rho_old = rho
        return z
    return precond


def make_chebyshev(A, degree: int = 4, eig_ratio: float = 30.0,
                   lambda_max: Optional[float] = None):
    """Chebyshev(degree) smoother on the Jacobi-preconditioned operator;
    lambda_max by host power iteration on D^{-1}A if not given."""
    inv_diag = 1.0 / A.diagonal()
    if lambda_max is None:
        S = A.to_scipy()
        d = inv_diag.detach().cpu().numpy().astype(np.float64)
        x = np.ones(A.n_rows)
        for _ in range(12):
            x = d * (S @ x)
            nrm = np.linalg.norm(x)
            if nrm == 0:
                break
            x = x / nrm
        lambda_max = float(x @ (d * (S @ x))) if np.linalg.norm(x) else 1.0
        lambda_max *= 1.1
    return chebyshev(A.matvec, inv_diag, lambda_max, degree, eig_ratio)


@dataclass
class MGSmoother:
    """deal.II ``MGSmootherPrecondition`` stepping (set_steps(k)):
    ``apply``: u = M^{-1} rhs, then (k-1) defect-correction steps;
    ``smooth``: k defect-correction steps from the current u."""

    A: object                       # CSR with .matvec
    precond: Callable
    steps: int = 2

    def apply(self, rhs):
        u = self.precond(rhs)
        for _ in range(self.steps - 1):
            u = u + self.precond(rhs - self.A.matvec(u))
        return u

    def smooth(self, u, rhs):
        for _ in range(self.steps):
            u = u + self.precond(rhs - self.A.matvec(u))
        return u


def lattice_color(forest, level_dofs) -> np.ndarray:
    """2^dim-colouring of level dofs by the parity of their lattice
    coordinates at the level's resolution (exact for Q1; for p > 1 a
    heuristic)."""
    p = getattr(level_dofs, "degree", 1)
    coords = forest.nkey_to_coords(level_dofs.keys, p)
    s = 1 << (forest.max_level - level_dofs.level)
    par = (coords // s) & 1
    color = np.zeros(len(coords), dtype=np.int64)
    for d in range(forest.dim):
        color |= par[:, d].astype(np.int64) << d
    return color
