"""The PyTorch port end to end on the CPU: the 8-atom published
trajectory, the same lattice with the FE-error postprocess and with the
brute-force density, the example ``.prm`` file through the port's CLI, and
resuming from a checkpoint that the JAX driver wrote.

The JAX device-operator run of the same configuration
(``tests/test_device_ops_driver.py:66``) was run once and its per-cycle
counts are inlined below, so the tier-1 run does not pay for it twice.  Its
totals include refinement passes that make no progress: on the CPU its
double-float32 defect stalls near 1e-7 * ||b|| and never reaches the
1e-8 * ||b|| target, so every cycle runs all four passes.  The first pass
(same warm start, same inner tolerance 1e-6) is the comparable count; the
port's float64 defect reaches the target, so its total may only be
smaller.

The two 8-atom runs with the reference's defaults restored
(``flag_postprocess_error=True``, then also ``flag_rhs_assembly=False``)
hold the port to the JAX device-operator run of the same configuration,
inlined below from one run of

    production_scaling_config(1, dtype="float32", solver_backend="tpu_cg",
                              device_operators="on", **flags)
    Simulation(cfg, atoms=nacl_lattice(1)).run()

(JAX on the CPU with x64, as tests/conftest.py sets it up; first-pass CG
counts read from ``StencilGMG.solve``).  FE errors agree to rel 1e-4 and
energies to rel 1e-5: the JAX run evaluates both in float32, the port
accumulates the FE error in float64."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.ops.density import dense_density
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient
from coulomb_gmg_tpu_torch.ops.tile_density import tile_density
from torch_parity import ROOT

torch.set_num_threads(2)

PUBLISHED_CELLS = [85184, 85744, 87648, 91344, 99464]
JAX_CG_TOTAL = [4, 10, 11, 11, 15]
JAX_CG_FIRST_PASS = [1, 4, 5, 5, 6]

# the JAX run of each flag set (see the module docstring)
JAX_DEFAULTS = {
    "fe": dict(
        flags=dict(flag_postprocess_error=True),
        fe=[0.301533043384552, 0.2565288841724396, 0.1937119960784912,
            0.1580086201429367, 0.1199013814330101],
        fe_long_range=[0.5040408820206551, 0.49786530207647356,
                       0.4898604140256719, 0.4615854706622474,
                       0.4573766346928798],
        total_split=[-11.592084362550384, -11.598259942494566,
                     -11.606264830545369, -11.634539773908793,
                     -11.63874860987816]),
    "brute+fe": dict(
        flags=dict(flag_postprocess_error=True, flag_rhs_assembly=False),
        fe=[0.301533043384552, 0.2565288841724396, 0.1937119960784912,
            0.1580086201429367, 0.1199013963341713],
        fe_long_range=[0.5040408814114304, 0.49786529761434006,
                       0.48986040509708584, 0.46158545488931124,
                       0.45737663092766906],
        total_split=[-11.59208436315961, -11.5982599469567,
                     -11.606264839473955, -11.634539789681728,
                     -11.63874861364337]),
}
JAX_ENERGY_8 = dict(analytic=-11.648239405039867,
                    short_range=-3.0690919078069396,
                    self_energy=9.0270333367641)


def _counts():
    return (ell_mv.launches, tile_density.launches, dense_density.launches,
            exact_gradient.launches)


def test_production_trajectory_8_atoms():
    cfg = production_scaling_config(1, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    launches = _counts()
    res = sim.run()
    assert [r["n_cells"] for r in res] == PUBLISHED_CELLS
    for r, total, first in zip(res, JAX_CG_TOTAL, JAX_CG_FIRST_PASS):
        assert 1 <= r["cg_iterations"] <= 20
        assert abs(r["cg_passes"][0] - first) <= 2
        assert r["cg_iterations"] <= total + 2
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
    assert np.isfinite(sim.solution).all()
    # CPU tensors run the plain versions: no kernel was launched
    assert _counts() == launches
    assert all(r["energy_norm_error"] is None for r in res)


@pytest.mark.parametrize("case", sorted(JAX_DEFAULTS))
def test_reference_defaults_8_atoms(case):
    """The FE-error postprocess (and the brute-force density) on the
    8-atom lattice: the published cells still come out."""
    ref = JAX_DEFAULTS[case]
    cfg = production_scaling_config(1, dtype="float32", **ref["flags"])
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    launches = _counts()
    res = sim.run()
    assert [r["n_cells"] for r in res] == PUBLISHED_CELLS
    for i, r in enumerate(res):
        assert abs(r["cg_passes"][0] - JAX_CG_FIRST_PASS[i]) <= 2
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
        assert abs(r["energy_norm_error"] / ref["fe"][i] - 1) < 1e-4
        e = r["energy"]
        for k in ("fe_long_range", "total_split"):
            assert abs(e[k] / ref[k][i] - 1) < 1e-5, (i, k)
        for k, v in JAX_ENERGY_8.items():
            assert abs(e[k] / v - 1) < 1e-12, (i, k)
        assert {"Postprocess FE error", "Postprocess electrostatic energy",
                "Compute charge densities"} <= set(r["stages"])
    assert _counts() == launches


def test_example_prm_through_cli_matches_jax(monkeypatch, capsys):
    """examples/gaussian-charges.prm (2 atoms, Exact boundary values,
    volume-residual Kelly, FE error) through the port's CLI, 2 cycles,
    against the JAX Simulation on the same file: cells exact, first-pass
    CG +-2, FE errors rel 1e-4, energies rel 1e-5."""
    import coulomb_gmg_tpu.solver.device_gmg as jdg
    from coulomb_gmg_tpu.config import load_prm
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    from coulomb_gmg_tpu_torch import cli

    monkeypatch.chdir(ROOT)          # the file names its atoms relatively
    prm = "examples/gaussian-charges.prm"
    jax_first = []                   # first-pass CG count of each cycle
    refine, solve = jdg.solve_refined_device, jdg.StencilGMG.solve

    def refine_rec(*a, **kw):
        jax_first.append(None)
        return refine(*a, **kw)

    def solve_rec(self, *a, **kw):
        out = solve(self, *a, **kw)
        if jax_first[-1] is None:
            jax_first[-1] = int(out[1])
        return out

    monkeypatch.setattr(jdg, "solve_refined_device", refine_rec)
    monkeypatch.setattr(jdg.StencilGMG, "solve", solve_rec)
    jcfg = load_prm(prm, dtype="float32", solver_backend="tpu_cg",
                    device_operators="on", n_adaptive_cycles=2)
    jres = JaxSimulation(jcfg, pcout=JaxPcout(enabled=False)).run()
    assert len(jax_first) == 2

    runs = []
    run = Simulation.run
    monkeypatch.setattr(Simulation, "run",
                        lambda self: runs.append(run(self)) or runs[-1])
    launches = _counts()
    assert cli.main([prm, "--device", "cpu", "--cycles", "2"]) == 0
    assert _counts() == launches
    log = capsys.readouterr().out
    assert log.count("Error in FE solution in energy norm:") == 2
    assert "Relative Error in total electrostatic energy" in log
    (res,) = runs
    assert [r["n_cells"] for r in res] == [r["n_cells"] for r in jres]
    for r, j, first in zip(res, jres, jax_first):
        assert abs(r["cg_passes"][0] - first) <= 2
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]
        assert abs(r["energy_norm_error"] / j["energy_norm_error"] - 1) < 1e-4
        for k in ("analytic", "short_range", "fe_long_range", "self_energy",
                  "total_split"):
            assert abs(r["energy"][k] / j["energy"][k] - 1) < 1e-5, k


def test_cli_no_fused_solve_selects_the_eager_solves(monkeypatch):
    """``--no-fused-solve`` (the JAX CLI's flag) sets ``solve_fused`` to
    False: the 8-atom lattice through the port's CLI, 2 cycles, with and
    without it gives the same cells, CG counts per refinement pass and
    solution bits (the stepped solve is the eager loop, op for op)."""
    from coulomb_gmg_tpu_torch import cli
    runs = []
    run = Simulation.run

    def record(self):
        res = run(self)
        runs.append((self.cfg.solve_fused, res, self.solution))
        return res
    monkeypatch.setattr(Simulation, "run", record)
    launches = _counts()
    for extra in ([], ["--no-fused-solve"]):
        assert cli.main(["--production", "1", "--device", "cpu",
                         "--cycles", "2", *extra]) == 0
    assert _counts() == launches
    (fused, res_f, sol_f), (eager, res_e, sol_e) = runs
    assert fused is True and eager is False
    assert [r["n_cells"] for r in res_f] == [r["n_cells"] for r in res_e] \
        == PUBLISHED_CELLS[:2]
    assert [r["cg_passes"] for r in res_f] == [r["cg_passes"] for r in res_e]
    assert np.array_equal(sol_f, sol_e)


def test_resume_from_jax_checkpoint(tmp_path):
    from coulomb_gmg_tpu import config as jconfig
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.models.atoms import nacl_lattice as jax_lattice
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    jcfg = jconfig.production_scaling_config(1, dtype="float32",
                                             solver_backend="tpu_cg",
                                             device_operators="on",
                                             n_adaptive_cycles=1,
                                             checkpoint_dir=str(tmp_path))
    JaxSimulation(jcfg, atoms=jax_lattice(1),
                  pcout=JaxPcout(enabled=False)).run()
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
