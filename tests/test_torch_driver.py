"""The production slice of the PyTorch port end to end on the CPU: the
8-atom published trajectory, and resuming from a checkpoint that the JAX
driver wrote.

The JAX device-operator run of the same configuration
(``tests/test_device_ops_driver.py:66``) was run once and its per-cycle
counts are inlined below, so the tier-1 run does not pay for it twice.  Its
totals include refinement passes that make no progress: on the CPU its
double-float32 defect stalls near 1e-7 * ||b|| and never reaches the
1e-8 * ||b|| target, so every cycle runs all four passes.  The first pass
(same warm start, same inner tolerance 1e-6) is the comparable count; the
port's float64 defect reaches the target, so its total may only be
smaller."""

import numpy as np
import torch

from coulomb_gmg_tpu.config import production_scaling_config
from coulomb_gmg_tpu.models.atoms import nacl_lattice
from coulomb_gmg_tpu.utils.logging import Pcout
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.tile_density import tile_density

torch.set_num_threads(2)

PUBLISHED_CELLS = [85184, 85744, 87648, 91344, 99464]
JAX_CG_TOTAL = [4, 10, 11, 11, 15]
JAX_CG_FIRST_PASS = [1, 4, 5, 5, 6]


def test_production_trajectory_8_atoms():
    cfg = production_scaling_config(1, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    launches = (ell_mv.launches, tile_density.launches)
    res = sim.run()
    assert [r["n_cells"] for r in res] == PUBLISHED_CELLS
    for r, total, first in zip(res, JAX_CG_TOTAL, JAX_CG_FIRST_PASS):
        assert 1 <= r["cg_iterations"] <= 20
        assert abs(r["cg_passes"][0] - first) <= 2
        assert r["cg_iterations"] <= total + 2
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
    assert np.isfinite(sim.solution).all()
    # CPU tensors run the plain versions: no kernel was launched
    assert (ell_mv.launches, tile_density.launches) == launches


def test_resume_from_jax_checkpoint(tmp_path):
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    jcfg = production_scaling_config(1, dtype="float32",
                                     solver_backend="tpu_cg",
                                     device_operators="on",
                                     n_adaptive_cycles=1,
                                     checkpoint_dir=str(tmp_path))
    JaxSimulation(jcfg, atoms=nacl_lattice(1),
                  pcout=Pcout(enabled=False)).run()
    ckpt = tmp_path / "ckpt_cycle000.npz"
    assert ckpt.exists()
    cfg = production_scaling_config(1, dtype="float32", n_adaptive_cycles=2,
                                    resume_from=str(ckpt),
                                    checkpoint_dir=str(tmp_path / "port"))
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    res = sim.run()
    assert [r["cycle"] for r in res] == [1]
    assert res[0]["n_cells"] == PUBLISHED_CELLS[1]
    assert abs(res[0]["cg_passes"][0] - JAX_CG_FIRST_PASS[1]) <= 2
    assert res[0]["residual"] <= 1.01e-8 * res[0]["l2_rhs"]
    # the port writes the same snapshot format back
    from coulomb_gmg_tpu.utils.checkpoint import load_checkpoint
    forest, sol, flags, _, _, done = load_checkpoint(
        str(tmp_path / "port" / "ckpt_cycle001.npz"))
    assert done == 1 and forest.n_cells == PUBLISHED_CELLS[1]
    np.testing.assert_array_equal(sol, sim.solution)
