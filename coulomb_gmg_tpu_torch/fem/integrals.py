"""Batched element integrals on axis-aligned cubic cells.

Counterpart of coulomb_gmg_tpu/fem/integrals.py.  Because every cell is a
cube of size h, the deal.II FEValues pipeline (``src/step-50.cc:744-790``)
reduces to contractions of precomputed reference tables:

  K[c,i,j] = h_c^{dim-2} * sum_q c(x_q) w_q (grad phi_i . grad phi_j)(q)
  f[c,i]   = h_c^{dim}   * sum_q rho(x_q) w_q phi_i(q)

:func:`stiffness_cells_np` and :func:`rhs_cells_np` are copies of the JAX
module's numpy twins (host assembly); :func:`stiffness_cells` and
:func:`rhs_cells` are the same contractions on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.q1 import ElementTables


def stiffness_cells(tables: ElementTables, h: torch.Tensor, coeff_q=None,
                    dtype: torch.dtype = None) -> torch.Tensor:
    """(n_cells, nb, nb) stiffness matrices on ``h``'s device.

    coeff_q: (n_cells, n_q) coefficient at quadrature points, or None for
    unit coefficient (GaussianCharges, include/step_50.h:331-336)."""
    dtype = dtype or h.dtype
    h = h.to(dtype)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                    device=h.device)
    scale = h ** (tables.dim - 2)
    w, G = put(tables.weights), put(tables.grad_outer)
    if coeff_q is None:
        k_ref = torch.einsum("q,qij->ij", w, G)
        return scale[:, None, None] * k_ref[None, :, :]
    k = torch.einsum("cq,qij->cij", coeff_q.to(dtype) * w[None, :], G)
    return scale[:, None, None] * k


def rhs_cells(tables: ElementTables, h: torch.Tensor, rho_q: torch.Tensor,
              dtype: torch.dtype = None) -> torch.Tensor:
    """(n_cells, nb) load vectors from density values at quadrature
    points."""
    dtype = dtype or h.dtype
    h = h.to(dtype)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                    device=h.device)
    f = (rho_q.to(dtype) * put(tables.weights)[None, :]) @ put(tables.phi)
    return (h ** tables.dim)[:, None] * f


def stiffness_cells_np(tables: ElementTables, h, coeff_q=None,
                       dtype=np.float64):
    """Numpy twin of :func:`stiffness_cells` for host assembly."""
    h = np.asarray(h, dtype)
    scale = h ** (tables.dim - 2)
    w = np.asarray(tables.weights, dtype)
    G = np.asarray(tables.grad_outer, dtype)
    if coeff_q is None:
        k_ref = np.einsum("q,qij->ij", w, G)
        return scale[:, None, None] * k_ref[None, :, :]
    cw = np.asarray(coeff_q, dtype) * w[None, :]
    k = np.tensordot(cw, G, axes=([1], [0]))
    return scale[:, None, None] * k


def rhs_cells_np(tables: ElementTables, h, rho_q, dtype=np.float64):
    """Numpy twin of :func:`rhs_cells`."""
    h = np.asarray(h, dtype)
    w = np.asarray(tables.weights, dtype)
    phi = np.asarray(tables.phi, dtype)
    f = (np.asarray(rho_q, dtype) * w[None, :]) @ phi
    return (h ** tables.dim)[:, None] * f
