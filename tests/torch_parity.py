"""Shared setup of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the JAX
reference (coulomb_gmg_tpu, on the CPU with x64, as conftest.py sets it up)
and the PyTorch port (coulomb_gmg_tpu_torch, on the CPU, where every kernel
wrapper runs its plain PyTorch version).  Meshes, atoms and constraints are
built with the port's host modules (tests/test_torch_host.py holds them
equal to the JAX package's); the JAX functions take them as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.q1 import element_tables

torch.set_num_threads(2)          # tier-1 runs several pytest workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_C = 0.5
CUT = 3.5 * R_C


def t64(a) -> torch.Tensor:
    """numpy -> float64 CPU tensor (integers keep their type); copies, so
    read-only (JAX-owned) arrays are fine."""
    a = np.array(a)
    t = torch.from_numpy(a)
    return t.to(torch.float64) if a.dtype.kind == "f" else t


def rel_err(a, b) -> float:
    """max|a - b| / max|b| over the common leading entries."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def adaptive_forest(dim: int = 3, reps: int = 6, cycles: int = 2,
                    seed: int = 0) -> Forest:
    """A refined forest with hanging nodes and refinement edges (the mesh
    of tests/test_stencil_ops.py)."""
    f = Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
    rng = np.random.default_rng(seed)
    for _ in range(cycles):
        centre = f.cell_lower() + 0.5 * f.cell_h()[:, None]
        r = np.linalg.norm(centre - 0.4, axis=1)
        f = f.refine(r < 0.3 + 0.05 * rng.standard_normal(f.n_cells))
    return f


def tile_setup(n: int = 1, vac: int = 3, refine_seed=None):
    """NaCl atoms and the production base mesh around them (the setup of
    tests/test_tile_density.py); ``refine_seed`` refines ~10% of the cells
    at random."""
    atoms = nacl_lattice(n)
    a = 2.0 * 0.25
    reps = int(round(2 * (n / a + 2 * vac)))
    f = Forest.uniform(3, reps, np.full(3, -vac * a), 0.25)
    if refine_seed is not None:
        rng = np.random.default_rng(refine_seed)
        f = f.refine(rng.random(f.n_cells) < 0.1)
    return f, atoms, element_tables(3, 1, 2)


def dipole_bc(pts: np.ndarray) -> np.ndarray:
    """Dipole far-field boundary values (nonzero, smooth)."""
    d = pts - 0.5
    return (d @ np.array([0.3, -0.2, 0.1])) / np.linalg.norm(d, axis=1) ** 3


def refined_problem(seed: int = 0):
    """(forest, dofs, constraints, rho (n_cells, n_q), tab_rhs): a refined
    mesh with hanging nodes, inhomogeneous Dirichlet values and a seeded
    density at the RHS quadrature points."""
    f = adaptive_forest(3, reps=6, cycles=2, seed=seed)
    dofs = f.dofs_of(1)
    con = build_constraints(dofs, dipole_bc)
    tab = element_tables(3, 1, 2)
    rng = np.random.default_rng(seed + 1)
    rho = rng.standard_normal((f.n_cells, len(tab.points)))
    return f, dofs, con, rho, tab


def jax_stencil_gmg(f, dofs, con):
    """The JAX StencilGMG in float64 on the CPU."""
    import jax.numpy as jnp
    from coulomb_gmg_tpu.solver.device_gmg import StencilGMG
    return StencilGMG(f, dofs, con, device=None, dtype=jnp.float64)


def torch_stencil_gmg(f, dofs, con):
    """The port's StencilGMG in float64 on the CPU."""
    from coulomb_gmg_tpu_torch.solver.device_gmg import StencilGMG
    return StencilGMG(f, dofs, con, "cpu", torch.float64)


def padded(v: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros(n_pad)
    out[: len(v)] = v
    return out


def random_csr(n: int, dtype, seed: int):
    """(indptr, indices, data) of a seeded n x n CSR: short rows (0 to 5
    entries), every length 0 to 51 where n allows, one row of 51 in an
    otherwise short slice, random columns, nonzero values."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, n)
    if n > 60:
        counts[8:60] = np.arange(52)
    counts[n // 2] = 51
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, n, indptr[-1])
    data = rng.standard_normal(indptr[-1]).astype(dtype)
    data[data == 0] = 1
    return indptr, indices, data
