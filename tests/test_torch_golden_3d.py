"""The PyTorch port's host-assembled path on the 3D goldens, on the CPU, in
float64 with the host SSOR smoother: the analytic-RHS GaussianCharges
trajectory of the reference's ``tests_3D/`` (tests/test_golden_3d_analytic.py,
5 cycles) and the Step16 trajectory of ``tests/step-16.mpirun=1.output``
with the 2-atom density RHS (tests/test_step16_3d.py, 5 cycles), with the
JAX tests' tolerances."""

import os

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import Config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.io.lammps import AtomData, read_lammps_file
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import ROOT

torch.set_num_threads(2)
N_CYCLES = 5

# tests_3D/gaussian-charges.mpirun=3.output (tests/test_golden_3d_analytic.py)
ANALYTIC = {
    "cells": [4096, 4152, 4544, 6056, 8464, 12328, 21176],
    "dofs": [4913, 5011, 5601, 7611, 10463, 15101, 25437],
    "cg": [7, 7, 9, 9, 9, 9, 9],
    "l2_sol": [0.325801, 0.657254, 1.62316, 2.86904, 4.60925, 5.72298,
               9.49857],
    "linf_sol": [0.216669, 0.183015, 0.178692, 0.17873, 0.179401,
                 0.179797, None],
}
# tests/step-16.mpirun=1.output (tests/test_step16_3d.py)
STEP16 = {
    "cells": [4096, 5160, 6742, 8758, 13952],
    "dofs": [4913, 6398, 8345, 10684, 17479],
    "cg": [8, 10, 11, 10, 14],
    "l2_sol": [1.00466, 1.28513, 1.62862, 2.07232, 2.59549],
    "linf_sol": [0.0537254, 0.0534342, 0.0536261, 0.0538256, 0.0538545],
    "cycle0": dict(start=0.0168501, l1_sol=41.1352),
}


@pytest.fixture(scope="module")
def analytic():
    cfg = Config(problem="GaussianCharges", dim=3, domain_left=-2.5,
                 domain_right=2.5, mesh_size_h=0.3125, vacuum_repetitions=0,
                 n_adaptive_cycles=N_CYCLES, r_c=0.5, nonzero_radius=3.0,
                 boundary_conditions="Inhomogeneous", preconditioner="GMG",
                 estimator_volume_term=False, dtype="float64",
                 flag_output_time=False)
    atoms = AtomData(np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int32),
                     np.zeros(3), np.zeros(3))
    sim = Simulation(cfg, atoms=atoms, device="cpu",
                     pcout=Pcout(enabled=False))
    assert not sim.lammpsinput and not sim.device_ops
    return sim.run()


@pytest.fixture(scope="module")
def step16():
    atoms = read_lammps_file(os.path.join(ROOT, "examples", "atom_2.data"),
                             3)
    assert atoms.has_atoms
    cfg = Config(problem="Step16", dim=3, n_global_refinements=4,
                 domain_left=0.0, domain_right=1.0,
                 n_adaptive_cycles=N_CYCLES,
                 boundary_conditions="Homogeneous", preconditioner="GMG",
                 r_c=0.5, nonzero_radius=3.5, flag_rhs_assembly=True,
                 estimator_volume_term=False, dtype="float64",
                 flag_output_time=False)
    sim = Simulation(cfg, atoms=atoms, device="cpu",
                     pcout=Pcout(enabled=False))
    res = sim.run()
    assert sim.lists.n_cells == res[-1]["n_cells"]
    assert sim._support_mask().shape == (res[-1]["n_cells"], 2)
    return res


def test_analytic_trajectory_exact(analytic):
    assert [r["n_cells"] for r in analytic] == ANALYTIC["cells"][:N_CYCLES]
    assert [r["n_dofs"] for r in analytic] == ANALYTIC["dofs"][:N_CYCLES]


def test_analytic_solution_norms(analytic):
    for r, l2, li in zip(analytic, ANALYTIC["l2_sol"], ANALYTIC["linf_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)
        if li is not None:
            assert r["linf_sol"] == pytest.approx(li, rel=1e-5)


def test_analytic_cg_counts(analytic):
    for r, g in zip(analytic, ANALYTIC["cg"]):
        assert 1 <= r["cg_iterations"] <= g + 1
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]


def test_step16_cycle0_topology(step16):
    assert step16[0]["n_cells"] == 4096
    assert step16[0]["n_dofs"] == 4913
    assert step16[0]["dofs_by_level"] == [8, 27, 125, 729, 4913]


def test_step16_cycle0_norms(step16):
    g = STEP16["cycle0"]
    assert step16[0]["cg_start"] == pytest.approx(g["start"], rel=1e-5)
    assert step16[0]["l1_sol"] == pytest.approx(g["l1_sol"], rel=1e-5)


def test_step16_trajectory_exact(step16):
    assert [r["n_cells"] for r in step16] == STEP16["cells"][:N_CYCLES]
    assert [r["n_dofs"] for r in step16] == STEP16["dofs"][:N_CYCLES]


def test_step16_solution_norms(step16):
    for r, l2, li in zip(step16, STEP16["l2_sol"], STEP16["linf_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)
        assert r["linf_sol"] == pytest.approx(li, rel=1e-5)


def test_step16_cg_counts(step16):
    for i, r in enumerate(step16):
        assert 1 <= r["cg_iterations"] <= STEP16["cg"][i] + 1
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
        assert "energy_norm_error" not in r        # Step16: no FE error
