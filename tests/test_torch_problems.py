"""models/problems.py of the PyTorch port against the JAX reference on the
same seeded points, float64, rel 1e-12."""

import numpy as np
import jax.numpy as jnp
import torch

from coulomb_gmg_tpu.models import problems as J
from coulomb_gmg_tpu_torch.models import problems as T
from torch_parity import R_C, rel_err, t64

torch.set_num_threads(2)


def _points(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3.0, 3.0, (n, 3))


def test_gaussian_rhs():
    p = _points(0)
    ref = np.asarray(J.gaussian_rhs(jnp.asarray(p), R_C))
    assert rel_err(T.gaussian_rhs(t64(p), R_C).numpy(), ref) < 1e-12


def test_analytic_solution_including_atom_sites():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.0, 1.0, (7, 3))
    q = rng.choice([-1.0, 1.0], 7)
    p = np.vstack([_points(2), pos[:2]])       # two points ON atoms (r -> 0)
    ref = np.asarray(J.analytic_solution(jnp.asarray(p), jnp.asarray(pos),
                                         jnp.asarray(q), R_C))
    out = T.analytic_solution(t64(p), t64(pos), t64(q), R_C).numpy()
    assert rel_err(out, ref) < 1e-12


def test_nonzero_dbc_dipole_and_quadrupole():
    rng = np.random.default_rng(3)
    p = _points(4) + 10.0                      # far-field boundary points
    x0 = rng.standard_normal(3)
    dip = rng.standard_normal(3)
    Q = rng.standard_normal((3, 3))
    ref = np.asarray(J.nonzero_dbc(jnp.asarray(p), x0, dip, Q))
    out = T.nonzero_dbc(t64(p), x0, dip, Q).numpy()
    assert rel_err(out, ref) < 1e-12


def test_dipole_moment():
    rng = np.random.default_rng(5)
    pos = rng.standard_normal((50, 3))
    q = rng.standard_normal(50)
    np.testing.assert_allclose(T.compute_dipole_moment(pos, q),
                               J.compute_dipole_moment(pos, q), rtol=1e-12)


def test_step16_functions():
    p = _points(6)
    pt = t64(p)
    np.testing.assert_array_equal(T.step16_rhs(pt).numpy(),
                                  np.asarray(J.step16_rhs(jnp.asarray(p))))
    inside = np.vstack([p, [[0.1, 0.2, 0.3], [0.0, 0.0, 0.49]]])
    np.testing.assert_array_equal(
        T.step16_coefficient(t64(inside)).numpy(),
        np.asarray(J.step16_coefficient(jnp.asarray(inside))))
    np.testing.assert_array_equal(
        T.gaussian_coefficient(pt).numpy(),
        np.asarray(J.gaussian_coefficient(jnp.asarray(p))))


def test_analytic_solution_without_lammps_including_origin():
    p = np.vstack([_points(7), np.zeros((1, 3))])
    ref = np.asarray(J.analytic_solution_without_lammps(jnp.asarray(p), R_C))
    out = T.analytic_solution_without_lammps(t64(p), R_C).numpy()
    assert rel_err(out, ref) < 1e-12


def test_quadrupole_moments():
    from torch_parity import adaptive_forest
    from coulomb_gmg_tpu_torch.ops.q1 import element_tables
    rng = np.random.default_rng(8)
    f = adaptive_forest(3, reps=4, cycles=1)
    tab = element_tables(3, 1, 2)
    rho = rng.standard_normal((f.n_cells, len(tab.points)))
    ref = J.quadrupole_from_forest(f, tab.points, tab.weights, rho,
                                   chunk=100)
    out = T.quadrupole_from_forest(f, tab.points, tab.weights, rho,
                                   chunk=100)
    assert rel_err(out, ref) < 1e-12
    pts = rng.standard_normal((5, 4, 3))
    jxw, rq = rng.random((2, 5, 4))
    assert rel_err(T.compute_quadrupole_moment(pts, jxw, rq),
                   J.compute_quadrupole_moment(pts, jxw, rq)) < 1e-12
