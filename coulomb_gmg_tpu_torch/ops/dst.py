"""Exact tensor-product (fast-DST) solver for the uniform-box Q1 Laplacian.

Counterpart of coulomb_gmg_tpu/ops/dst.py, the GMG coarse solve.  The
level-0 mesh of GaussianCharges is a full uniform box, so for unit
coefficient the interior-node operator is
``A (x) M (x) M + M (x) A (x) M + M (x) M (x) A`` and the sine vectors
diagonalize it: the solve is ``dim`` sine-transform contractions, a
pointwise divide by the tensor eigenvalues, and ``dim`` more contractions.
The precompute is numpy (copied: the JAX module imports jax); the apply is
``torch.tensordot``, a plain matrix product with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DSTPoisson:
    """Direct solver for the interior-node Q1 Laplacian on an
    ``(m-1)^dim`` interior lattice (m cells per axis), unit coefficient,
    homogeneous Dirichlet boundary."""

    dim: int
    m: int                    # cells per axis (nodes per axis = m + 1)
    h: float
    S: np.ndarray             # (n_i, n_i) orthonormal sine transform
    lam: np.ndarray           # (n_i,)*dim tensor eigenvalues

    @staticmethod
    def build(dim: int, m: int, h: float, dtype=np.float32) -> "DSTPoisson":
        k = np.arange(1, m, dtype=np.float64)
        i = np.arange(1, m, dtype=np.float64)
        # DST-I, orthonormalized: S @ S = I
        S = np.sqrt(2.0 / m) * np.sin(np.pi * np.outer(k, i) / m)
        t = np.pi * k / m
        a = (2.0 / h) * (1.0 - np.cos(t))
        mm = (h / 6.0) * (4.0 + 2.0 * np.cos(t))
        if dim == 3:
            lam = (np.einsum("p,q,r->pqr", a, mm, mm)
                   + np.einsum("p,q,r->pqr", mm, a, mm)
                   + np.einsum("p,q,r->pqr", mm, mm, a))
        elif dim == 2:
            lam = (np.einsum("p,q->pq", a, mm)
                   + np.einsum("p,q->pq", mm, a))
        else:
            lam = a
        return DSTPoisson(dim=dim, m=m, h=h, S=S.astype(dtype),
                          lam=lam.astype(dtype))


def _transform(S: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    for ax in range(u.dim()):
        u = torch.movedim(
            torch.tensordot(S, torch.movedim(u, ax, 0), dims=([1], [0])),
            0, ax)
    return u


def dst_solve(S: torch.Tensor, lam: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Solve ``K u = b`` for interior values; ``b`` has shape (m-1,)*dim."""
    return _transform(S, _transform(S, b) / lam)
