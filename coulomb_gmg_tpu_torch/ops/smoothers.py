"""Multigrid smoothers.

Counterpart of coulomb_gmg_tpu/ops/smoothers.py.  The reference smooths
with Trilinos ``PreconditionSSOR`` (damping 0.5, two steps,
src/step-50.cc:969-973), an inherently sequential sweep:

* ``ssor``: exact sequential SSOR (:func:`make_ssor`), the reference's
  smoother and that of every golden.  On the CPU :class:`HostSSOR`, sparse
  triangular solves in host scipy, float64, as the JAX package defines
  it: each application copies the defect to the host and the result back
  (the run's ``host_reads`` and ``uploads``) and solves in a span
  ``smoother.ssor_host``.  On a card :class:`CardSSOR`, the same sweep in
  the hand kernel ``csrc/ssor_sweep.cu`` (host scipy is its plain
  version), a span ``smoother.ssor`` and a count ``ssor_card_calls`` each
  application;
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

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.solver.cg import host_array
from coulomb_gmg_tpu_torch.utils.timer import count, span
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

    The solves of each application are a span ``smoother.ssor_host`` of
    the run (utils/timer.py); the defect's copy to the host counts in its
    ``host_reads``, the result's copy back in its ``uploads``."""

    def __init__(self, A, omega: float = 0.5):
        import scipy.sparse as sp
        S = A.to_scipy().tocsr().astype(np.float64)
        D = S.diagonal()
        Dw = sp.diags(D / omega)
        self.S = S
        self.lower = (Dw + sp.tril(S, k=-1, format="csr")).tocsr()
        self.upper = (Dw + sp.triu(S, k=1, format="csr")).tocsr()

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        import scipy.sparse.linalg as spla
        rh = host_array(r.detach()).astype(np.float64)
        with span("smoother.ssor_host"):
            y1 = spla.spsolve_triangular(self.lower, rh, lower=True)
            y = y1 + spla.spsolve_triangular(self.upper, rh - self.S @ y1,
                                             lower=False)
        return upload(y, r.device, r.dtype)


_SSOR_FN = {torch.float32: "ssor_sweep_f32", torch.float64: "ssor_sweep_f64"}
_SSOR_SIGS = {f: [ctypes.c_void_p] * 5 + [ctypes.c_double]
              + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
              for f in _SSOR_FN.values()}
# the bits of "not published yet" in the sweep's polled vectors (a NaN no
# arithmetic returns; csrc/ssor_sweep.cu:kNotYet)
NOT_YET = int(np.array([0x7FF4DEAD5EED0001], np.uint64).view(np.int64)[0])


class CardSSOR:
    """:class:`HostSSOR`'s sweep on the card that holds ``A``: the kernel
    ``csrc/ssor_sweep.cu`` reads the level matrix's values where they lie,
    its pattern uploaded once in int32 and its diagonal, and keeps three
    float64 vectors of its own (``yp`` and ``z``, polled by the kernel's
    warps and holding :data:`NOT_YET` between applications, and ``y1``)
    and two tickets.  Each application is a span ``smoother.ssor`` of the
    run and adds 1 to its counter ``ssor_card_calls``; the defect never
    leaves the card.  Built on the CPU it holds the same
    operands, and an application raises."""

    def __init__(self, A, omega: float = 0.5):
        if A.n_rows != A.n_cols or A.nnz >= 2 ** 31:
            raise ValueError(f"CardSSOR: a square matrix of fewer than 2^31 "
                             f"nonzeros, not {A.n_rows} x {A.n_cols} with "
                             f"{A.nnz}")
        # a warp would wait forever on a column that is no row
        if A.nnz and not 0 <= A.indices.min() <= A.indices.max() < A.n_rows:
            raise ValueError("CardSSOR: column indices outside the rows")
        dev = A.data.device
        self.A, self.omega = A, float(omega)
        self.indptr = upload(A.indptr.astype(np.int32), dev)
        self.indices = upload(A.indices.astype(np.int32), dev)
        self.diag = A.diagonal()
        not_yet = lambda: torch.full((A.n_rows,), NOT_YET, dtype=torch.int64,
                                     device=dev).view(torch.float64)
        self.yp, self.z = not_yet(), not_yet()
        self.y1 = torch.empty(A.n_rows, dtype=torch.float64, device=dev)
        self.tickets = torch.zeros(2, dtype=torch.int32, device=dev)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        with span("smoother.ssor"):
            y = ssor_sweep(self.indptr, self.indices, self.A.data, self.diag,
                           r, self.omega, self.yp, self.y1, self.z,
                           self.tickets)
            count("ssor_card_calls")
        return y


def ssor_sweep(indptr, indices, vals, diag, r, omega, yp, y1, z,
               tickets) -> torch.Tensor:
    """One SSOR application ``y`` (dtype of ``r``) in the kernel, on the
    current stream: ``indptr``/``indices`` the int32 pattern, ``vals`` and
    ``diag`` the matrix's values and diagonal in ``r``'s dtype; ``yp``,
    ``y1``, ``z`` float64 and ``tickets`` int32, state kept between
    applications (``yp``, ``z`` :data:`NOT_YET` and ``tickets`` zeros
    before the first).  Raises on operands the kernel does not take, and on
    any that are not on one card."""
    n = len(diag)
    if r.dtype not in _SSOR_FN or {vals.dtype, diag.dtype} != {r.dtype}:
        raise TypeError(f"ssor_sweep: values, diagonal and defect in one "
                        f"of float32/float64, got {vals.dtype}/{diag.dtype}/"
                        f"{r.dtype}")
    if (indptr.dtype, indices.dtype, tickets.dtype) != (torch.int32,) * 3 \
            or {yp.dtype, y1.dtype, z.dtype} != {torch.float64}:
        raise TypeError("ssor_sweep: int32 pattern and tickets, float64 "
                        "yp, y1 and z")
    ops = (indptr, indices, vals, diag, r, yp, y1, z, tickets)
    if (any(t.dim() != 1 for t in ops) or len(indptr) != n + 1
            or len(indices) != len(vals) or len(tickets) != 2
            or any(len(t) != n for t in (r, yp, y1, z))):
        raise ValueError(f"ssor_sweep: shapes {[tuple(t.shape) for t in ops]}"
                         f" for {n} rows")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssor_sweep: operands must be contiguous")
    if not all(t.is_cuda and t.device == r.device for t in ops):
        raise ValueError("ssor_sweep: every operand must be on one CUDA card")
    y = torch.empty_like(r)
    lib = kernels.library("ssor_sweep", _SSOR_SIGS)
    kernels.launch(getattr(lib, _SSOR_FN[r.dtype]), r.device, "ssor_sweep",
                   indptr.data_ptr(), indices.data_ptr(), vals.data_ptr(),
                   diag.data_ptr(), r.data_ptr(), float(omega),
                   yp.data_ptr(), y1.data_ptr(), z.data_ptr(), y.data_ptr(),
                   tickets.data_ptr(), n)
    ssor_sweep.launches += 1
    return y


ssor_sweep.launches = 0   # applications (each the forward and backward kernel)


def make_ssor(A, omega: float = 0.5):
    """Exact SSOR where ``A`` lies: :class:`CardSSOR` on a card,
    :class:`HostSSOR` on the CPU."""
    return CardSSOR(A, omega) if A.data.is_cuda else HostSSOR(A, omega)


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
        w = upload(omega / diag[rows], dev, A.data.dtype)
        slices.append((upload(rows, dev), cols, vals, w))

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
    level_dofs = level_dofs.host
    p = getattr(level_dofs, "degree", 1)
    coords = forest.nkey_to_coords(level_dofs.keys, p)
    s = 1 << (forest.max_level - level_dofs.level)
    par = (coords // s) & 1
    color = np.zeros(len(coords), dtype=np.int64)
    for d in range(forest.dim):
        color |= par[:, d].astype(np.int64) << d
    return color
