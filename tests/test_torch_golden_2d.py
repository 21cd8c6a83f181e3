"""The PyTorch port's host-assembled path on the 2D goldens, on the CPU:
the reference's ``tests_2D/`` trajectories (the oracle of
tests/test_golden_2d.py, inlined there from the reference's output files)
with the JAX tests' tolerances, float64, the host SSOR smoother and the
host-loop CG; plus the degree-2 Step16 smoke run of tests/test_qp.py:154
and the Jacobi run of tests/test_2d.py:46."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import Config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.io.lammps import AtomData
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.utils.logging import Pcout

torch.set_num_threads(2)

# tests_2D/step-16.mpirun=1.output:5-43 (tests/test_golden_2d.py:34)
STEP16_2D = {
    "cells": [256, 418, 865, 1219, 1297],
    "dofs": [289, 495, 952, 1354, 1446],
    "cg": [7, 10, 11, 13, 13],
    "l2_sol": [4.75978, 5.65081, 9.64327, 10.0806, 10.13],
    "linf_sol": [0.572697, 0.57747, 0.577873, 0.579166, 0.57931],
}
# tests_2D/gaussian-charges.mpirun=1.output (tests/test_golden_2d.py:42)
GAUSS_2D = {
    "cells": [256, 268, 328, 460, 712, 1084, 1744, 2824],
    "cg": [6, 6, 7, 7, 8, 8, 8, 8],
    "l2_sol": [2.02616, 2.48688, 4.07305, 5.97429, 8.38942, 11.0898,
               14.6293, 18.0956],
}


def _empty(dim):
    return AtomData(np.zeros((0, dim)), np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(dim), np.zeros(dim))


def _run(cfg):
    sim = Simulation(cfg, atoms=_empty(cfg.dim), device="cpu",
                     pcout=Pcout(enabled=False))
    before = ell_mv.launches
    res = sim.run()
    assert ell_mv.launches == before          # CPU: plain versions only
    assert not sim.device_ops and not sim.use_tpu_cg
    return res


@pytest.fixture(scope="module")
def run_step16_2d():
    return _run(Config(problem="Step16", dim=2, n_global_refinements=4,
                       domain_left=0.0, domain_right=1.0,
                       n_adaptive_cycles=5,
                       boundary_conditions="Homogeneous",
                       preconditioner="GMG", estimator_volume_term=False,
                       dtype="float64", flag_output_time=False))


@pytest.fixture(scope="module")
def run_gauss_2d():
    return _run(Config(problem="GaussianCharges", dim=2, domain_left=-2.5,
                       domain_right=2.5, mesh_size_h=0.3125,
                       vacuum_repetitions=0, n_adaptive_cycles=8, r_c=0.5,
                       nonzero_radius=3.0,
                       boundary_conditions="Inhomogeneous",
                       preconditioner="GMG", estimator_volume_term=False,
                       dtype="float64", flag_output_time=False))


def test_step16_2d_trajectory_exact(run_step16_2d):
    assert [r["n_cells"] for r in run_step16_2d] == STEP16_2D["cells"]
    assert [r["n_dofs"] for r in run_step16_2d] == STEP16_2D["dofs"]


def test_step16_2d_solution_norms(run_step16_2d):
    for r, l2, li in zip(run_step16_2d, STEP16_2D["l2_sol"],
                         STEP16_2D["linf_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)
        assert r["linf_sol"] == pytest.approx(li, rel=1e-5)


def test_step16_2d_cg_counts(run_step16_2d):
    for r, g in zip(run_step16_2d, STEP16_2D["cg"]):
        assert 1 <= r["cg_iterations"] <= g + 1
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
        assert r["l1_mat"] > 0 and r["coarse_cg"]


def test_gauss_2d_trajectory_exact(run_gauss_2d):
    assert [r["n_cells"] for r in run_gauss_2d] == GAUSS_2D["cells"]


def test_gauss_2d_solution_norms(run_gauss_2d):
    for r, l2 in zip(run_gauss_2d, GAUSS_2D["l2_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)


def test_gauss_2d_cg_counts(run_gauss_2d):
    for r, g in zip(run_gauss_2d, GAUSS_2D["cg"]):
        assert 1 <= r["cg_iterations"] <= g + 1


def test_step16_2d_degree2_smoke():
    """Polynomial degree 2 (tests/test_qp.py:154): Step16 2D, 2 cycles."""
    res = _run(Config(problem="Step16", dim=2, degree=2,
                      n_global_refinements=2, n_adaptive_cycles=2,
                      preconditioner="GMG",
                      boundary_conditions="Homogeneous",
                      flag_output_time=False))
    assert len(res) == 2
    for r in res:
        assert r["cg_iterations"] <= 25
    assert res[0]["n_dofs"] > (2 ** 2 + 1) ** 2


def test_jacobi_preconditioner_2d():
    """Jacobi-preconditioned CG (tests/test_2d.py:46)."""
    res = _run(Config(problem="Step16", dim=2, n_global_refinements=3,
                      domain_left=-1.0, domain_right=1.0,
                      n_adaptive_cycles=1, boundary_conditions="Homogeneous",
                      preconditioner="Jacobi", flag_output_time=False,
                      cg_max_iters=500))
    assert res[0]["cg_iterations"] < 200
    assert np.isfinite(res[0]["l2_sol"])
    assert res[0]["residual"] <= 1.01e-8 * res[0]["l2_rhs"]
