"""The PyTorch port's host-assembled path end to end on the CPU: the
8-atom published trajectory in float64 (the oracle of
tests/test_production_trajectory.py: ``REF_CELLS[8]`` exactly, CG within
+-1 of ``REF_CG_8``), and ``examples/step-16.prm`` through the port's CLI
(float32 by default, the ``TpuGMG`` / ``solve_refined`` route; float64 with
``--float64``, the host-loop CG with the host SSOR smoother).

The JAX ``Simulation`` on the same file (JAX on the CPU with x64, as
tests/conftest.py sets it up) was run once per precision and its
per-cycle cells and CG counts are inlined below:

    load_prm("examples/step-16.prm", dtype="float32", smoother="mc_ssor",
             solver_backend="tpu_cg")            # the float32 CLI defaults
    load_prm("examples/step-16.prm")             # float64, SSOR
    Simulation(cfg).run()

The float32 run went through ``TpuGMG.solve(..., fused=True)``, the JAX
package's accelerator solve: its host block-CG (``fused=False``, what a
CPU run takes) turns the run into NaN from cycle 1 on this mesh, its
coarse CG dividing 0 by 0 (ROADMAP.md, Queue 3).  The port's coarse CG
follows the fused executable.
"""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import ROOT

torch.set_num_threads(2)

# Plotting/ncells_per_atom.dat:6-12, SSOR_run.o876223:18-54
# (tests/test_production_trajectory.py:35-44)
REF_CELLS_8 = [85184, 85744, 87648, 91344, 99464]
REF_CG_8 = [1, 6, 8, 7, 8]
# the JAX runs of examples/step-16.prm (see the module docstring)
JAX_STEP16 = {
    "float32": dict(cells=[4096, 5307, 7526, 10032, 17312],
                    cg=[6, 15, 15, 17, 17]),
    "float64": dict(cells=[4096, 5307, 7526], cg=[6, 9, 9]),
}


def test_production_trajectory_8_atoms_float64():
    cfg = production_scaling_config(1, dtype="float64")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    assert not sim.device_ops and not sim.use_tpu_cg
    res = sim.run()
    assert [r["n_cells"] for r in res] == REF_CELLS_8
    for r, ref in zip(res, REF_CG_8):
        assert abs(r["cg_iterations"] - ref) <= 1, r["cycle"]
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
    assert res[0]["cg_start"] == pytest.approx(0.670321, rel=1e-6)
    assert np.isfinite(sim.solution).all()
    # 8 atoms: the mask of the JAX driver, as compact lists
    assert sim.lists.n_cells == REF_CELLS_8[-1]


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_step16_prm_through_cli_matches_jax(monkeypatch, capsys, precision):
    from coulomb_gmg_tpu_torch import cli
    monkeypatch.chdir(ROOT)          # the file names its atoms relatively
    runs = []
    run = Simulation.run
    monkeypatch.setattr(Simulation, "run",
                        lambda self: runs.append((self, run(self)))
                        or runs[-1][1])
    ref = JAX_STEP16[precision]
    cycles = len(ref["cells"])
    argv = ["examples/step-16.prm", "--device", "cpu", "--cycles",
            str(cycles)]
    if precision == "float64":
        argv.append("--float64")
    launches = ell_mv.launches
    assert cli.main(argv) == 0
    assert ell_mv.launches == launches
    log = capsys.readouterr().out
    assert log.count("CG converged in") == cycles
    assert "Problem type is:   Step16" in log
    ((sim, res),) = runs
    assert sim.dtype == getattr(torch, precision)
    assert sim.use_tpu_cg == (precision == "float32")
    assert [r["n_cells"] for r in res] == ref["cells"]
    for r, k in zip(res, ref["cg"]):
        assert abs(r["cg_iterations"] - k) <= 1
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
