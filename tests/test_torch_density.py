"""Brute-force density of the PyTorch port (ops/density.py, plain version on
the CPU) against the JAX package: float64 against the brute-force branch of
``compute_density`` (its separable path on the CPU; rel 1e-10), float32
against the Pallas kernel ``density_pallas_cells(..., interpret=True)`` at
the tolerances of tests/test_kernels.py:180 (rtol 5e-4, atol 1e-5); the
padding rows of the RHS-assembly contract exactly zero."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.ops.density import compute_density
from coulomb_gmg_tpu.ops.pallas_density import density_pallas_cells
from coulomb_gmg_tpu_torch.ops import density as dd
from torch_parity import R_C, adaptive_forest, rel_err, t64, tile_setup

torch.set_num_threads(2)


def _atoms(seed=5, A=37):
    """The atoms of tests/test_kernels.py:170."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.2, 1.8, (A, 3)) / 2.0, rng.choice([-1.0, 1.0], A)


@pytest.mark.parametrize("n_q1", [2, 3])
def test_plain_float64_matches_jax_bruteforce(n_q1):
    from coulomb_gmg_tpu.ops.q1 import element_tables
    f = adaptive_forest(3, reps=4, cycles=1)
    tab = element_tables(3, 1, n_q1)
    pos, q = _atoms()
    ref = compute_density(f, tab.points, pos, q, R_C)
    const = 4.0 * np.pi / (R_C ** 3 * np.pi ** 1.5)
    out = dd.dense_density_plain(
        t64(f.cell_lower()), t64(f.cell_h()), t64(tab.points),
        dd.pack_atoms(pos, q, "cpu", torch.float64),
        inv_rc2=1.0 / (R_C * R_C), scale=const, n_out=f.n_cells)
    assert out.dtype == torch.float64
    assert rel_err(out.numpy(), ref) < 1e-10


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_float32_matches_pallas_interpret(refine_seed):
    f, atoms, tab = tile_setup(1, 2, refine_seed)
    ref = np.asarray(density_pallas_cells(
        f.cell_lower(), f.cell_h(), tab.points, atoms.positions,
        atoms.charges, R_C, p_tile=128, a_tile=128, interpret=True))
    out = dd.density_bruteforce(f, tab.points, atoms.positions,
                                atoms.charges, R_C, "cpu",
                                c_pad=f.n_cells + 1)
    assert out.dtype == torch.float32
    assert out.shape == (f.n_cells + 1, len(tab.points))
    np.testing.assert_allclose(out[: f.n_cells].numpy(), ref, rtol=5e-4,
                               atol=1e-5)


def test_padding_rows_exactly_zero():
    f, atoms, tab = tile_setup(1, 2)
    out = dd.density_bruteforce(f, tab.points, atoms.positions,
                                atoms.charges, R_C, "cpu",
                                c_pad=f.n_cells + 3)
    assert out.shape[0] == f.n_cells + 3
    assert not out[f.n_cells:].any()
    assert out[: f.n_cells].abs().max() > 0


def test_cpu_dispatch_is_plain_and_cuda_path_never_falls_back():
    f, atoms, tab = tile_setup(1, 2)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, "cpu")
    before = dd.dense_density.launches
    out = dd.dense_density(*args, n_out=f.n_cells, **kw)
    assert torch.equal(out, dd.dense_density_plain(*args, n_out=f.n_cells,
                                                   **kw))
    assert dd.dense_density.launches == before
    with pytest.raises(ValueError):
        dd.dense_density_cuda(*args, n_out=f.n_cells, **kw)
