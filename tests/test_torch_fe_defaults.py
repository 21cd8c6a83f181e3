"""The reference's default run (all-atom density, volume-term Kelly, the
FE error of every cycle) through the port, against the plain float64
reference of the benchmark (gmg_bench/reference/: fe_error.py, kelly.py,
density.py), on seeded atom orders of the 8- and 64-atom lattices.

The meshes keep 4 vacuum repetitions instead of the study's 10, so that a
whole run takes a second or two on the CPU; the program and the reference
read the same settings, so the comparison is unchanged by it."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import estimate, mark_cells
from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops import gradient
from coulomb_gmg_tpu_torch.ops.density import density_bruteforce
from coulomb_gmg_tpu_torch.postprocess import energy
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from coulomb_gmg_tpu_torch.utils.timer import RUNS
from gmg_bench import cells, check, run
from gmg_bench.reference import fe_error, fem, kelly
from gmg_bench.reference.density import density_at, member_table

CELL = cells.find_cell("nacl64k_fe_f32.production")
DEFAULTS = dict(flag_rhs_assembly=False, estimator_volume_term=True,
                flag_postprocess_error=True)


def config(n: int, **over):
    return production_scaling_config(
        n, **{"dtype": "float32", "solver_backend": "tpu_cg",
              "vacuum_repetitions": 4, "n_adaptive_cycles": 2, **DEFAULTS,
              **over})


def settings(cfg) -> dict:
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def solve(n: int, seed: int, **over):
    """A whole 2-cycle run of the ``8 n^3``-atom lattice listed in an order
    drawn from ``seed``: (the Simulation after it, its snapshots, atoms,
    settings)."""
    cfg = config(n, **over)
    at = nacl_lattice(n)
    perm = torch.randperm(at.n, generator=torch.Generator().manual_seed(
        seed)).numpy()
    at.positions, at.charges = at.positions[perm], at.charges[perm]
    at.types = at.types[perm]
    sim = Simulation(cfg, atoms=at, device="cpu", pcout=Pcout(enabled=False))
    shots = run.Snapshots(sim)
    shots.add_results(sim.run())
    return sim, shots.cycles, at, settings(cfg)


@pytest.fixture(scope="module", params=[1, 2], ids=["8_atoms", "64_atoms"])
def default_run(request):
    n = request.param
    sim, snaps, at, s = solve(n, 2 ** 33 + 17 * n)
    reps, lower, h0 = fem.base_grid(s)
    f = sim.forest
    mesh = fem.Mesh(reps, lower, h0, f.level, f.ijk)
    u, miss = fem.vertex_values(mesh, f.dofs_of(1).host.positions,
                                np.asarray(sim.solution))
    assert miss == 0
    P, Q = torch.tensor(at.positions), torch.tensor(at.charges)
    rho = density_at(mesh, member_table(reps, lower, h0, P,
                                        check.density_cut(s, h0)), P, Q,
                     s["r_c"])
    return dict(sim=sim, snaps=snaps, atoms=at, settings=s, mesh=mesh, u=u,
                rho=rho, P=P, Q=Q, run=RUNS[-1])


# float64: the program's plain gradient and the reference's far-field
# products differ in rounding only (1e-14 a term, 64 terms); float32: the
# program's points, cell values and gradient are float32 (rel 6e-8 each),
# summed over 8 Gauss points and up to 64 atoms, read here at 2.4e-7 and
# 4.4e-7
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_the_fe_error_is_the_references(default_run, dtype, tol):
    d = default_run
    sim, s = d["sim"], d["settings"]
    got = energy.energy_norm_error(sim.forest, sim.tab_lap, sim.solution,
                                   d["atoms"].positions, d["atoms"].charges,
                                   s["r_c"], "cpu", dtype=dtype)
    want = fe_error.energy_norm_error(d["mesh"], d["u"], d["P"], d["Q"],
                                      s["r_c"])
    assert want > 0
    assert abs(got - want) / want < tol
    assert sim.results[-1]["energy_norm_error"] == pytest.approx(
        energy.energy_norm_error(sim.forest, sim.tab_lap, sim.solution,
                                 d["atoms"].positions, d["atoms"].charges,
                                 s["r_c"], "cpu"), rel=1e-12)


def test_the_reference_gradient_sums_every_atom():
    # the far form from FAR r_c and the whole formula inside it, against
    # the whole formula over every pair; points at 0.1 to 40 r_c
    gen = torch.Generator().manual_seed(5)
    X = torch.rand(300, 3, generator=gen, dtype=torch.float64) * 8.0
    q = torch.where(torch.rand(300, generator=gen) < 0.5, 1.0, -1.0).double()
    x = torch.rand(2000, 3, generator=gen, dtype=torch.float64) * 28 - 10
    atoms = torch.cat([X, q[:, None]], 1)
    want = gradient.exact_gradient_plain(x, atoms, 0.5)
    got = fe_error.exact_gradient(x, X, q, 0.5)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-13
    low = fe_error.exact_gradient(x, X, q, 0.5, dtype=torch.bfloat16)
    assert (low - want).abs().max() / want.abs().max() > 1e-3


# both sides are float64 on the same solution and density: the program
# sums each cell's faces in another order (rel 4e-16 read)
@pytest.mark.parametrize("volume", [True, False])
def test_the_indicator_and_threshold_are_the_references(default_run, volume):
    d = default_run
    sim, f = d["sim"], d["sim"].forest
    got = estimate(f, f.dofs_of(1).cell2dof, np.asarray(sim.solution),
                   d["rho"], sim.tab_rhs.points, sim.tab_rhs.weights,
                   use_volume_term=volume)
    want = kelly.indicator(d["mesh"], d["u"], d["rho"], volume)
    assert float(((got - want).abs() / want.max()).max()) < 1e-13
    flags, theta = mark_cells(got, d["settings"]["refine_fraction_of_max"])
    assert theta == pytest.approx(0.6 * float(want.max()), rel=1e-13)
    assert torch.equal(flags, want > theta)


# float32 terms rounded to 6e-8 each, up to 64 of them a point, against
# the float64 sum of every atom within 6 r_c (read at 5.6e-7 and 1.0e-6)
def test_the_all_atom_density_is_the_references(default_run):
    d = default_run
    sim = d["sim"]
    f = sim.forest
    got = density_bruteforce(f, sim.tab_rhs.points, d["atoms"].positions,
                             d["atoms"].charges, d["settings"]["r_c"], "cpu",
                             c_pad=f.n_cells + 1)
    assert not got[f.n_cells:].any()
    err = (got[:f.n_cells].double() - d["rho"]).abs().max()
    assert float(err / d["rho"].abs().max()) < 5e-6


def judge(d, snaps=None, settings=None):
    return check.compare(snaps or d["snaps"], d["atoms"].positions,
                         d["atoms"].charges, settings or d["settings"], None,
                         CELL.limits, 0, "cpu", seed=11, readers=CELL.checks)


def test_a_whole_run_is_correct(default_run):
    checks, correct = judge(default_run)
    assert correct, checks
    for k in ("fe_error_rel", "threshold_rel", "marks_missed",
              "splits_unmarked"):
        assert k in checks
    assert checks["marks_missed"]["value"] == 0
    assert checks["splits_unmarked"]["value"] == 0


def test_the_run_traces_its_new_parts(default_run):
    d = default_run
    r, n_atoms = d["run"], d["atoms"].n
    for name in ("fe.operands", "fe.gradient", "estimate.volume"):
        assert r["spans"][name]["calls"] == 2, name
    cells_ = [len(s["level"]) for s in d["snaps"]]
    fe = r["counters"]["Postprocess FE error"]
    assert fe["gradient_pairs"] == 8 * n_atoms * sum(cells_)
    assert r["counters"]["Compute charge densities"]["density_pairs"] == \
        8 * n_atoms * sum(cells_)


def test_a_wrong_fe_error_is_not_correct(default_run):
    snaps = [dict(s, energy_norm_error=1.01 * s["energy_norm_error"])
             for s in default_run["snaps"]]
    checks, correct = judge(default_run, snaps)
    assert not correct
    assert checks["fe_error_rel"]["value"] == pytest.approx(0.01, rel=1e-4)


def test_marking_without_the_volume_term_is_not_correct():
    sim, snaps, at, s = solve(1, 2 ** 33 + 3, estimator_volume_term=False)
    checks, correct = judge({"snaps": snaps, "atoms": at}, snaps,
                            dict(s, estimator_volume_term=True))
    assert not correct
    assert (checks["marks_missed"]["value"] > 0
            or checks["threshold_rel"]["value"]
            > checks["threshold_rel"]["limit"]), checks


def test_a_bfloat16_gradient_is_not_correct(monkeypatch):
    plain = gradient.exact_gradient_plain

    def low(points, atoms, r_c):
        return plain(points.bfloat16(), atoms.bfloat16(), r_c).to(
            points.dtype)

    monkeypatch.setattr(energy, "exact_gradient", low)
    sim, snaps, at, s = solve(1, 2 ** 33 + 5)
    checks, correct = judge({"snaps": snaps, "atoms": at, "settings": s})
    assert not correct
    assert checks["fe_error_rel"]["value"] > 10 * checks["fe_error_rel"][
        "limit"], checks


def test_a_replaced_mesh_frees_its_dof_records_at_once():
    # the DoF records of the forests that refinement replaced go by
    # reference counting alone: without the cycle collector, only the last
    # forest's record is left of the run (the card's peak memory must not
    # wait for the collector)
    import gc
    from coulomb_gmg_tpu_torch.mesh.dofs import DofInfo

    def records():
        return {id(o) for o in gc.get_objects() if isinstance(o, DofInfo)}

    gc.collect()
    before = records()
    gc.disable()
    try:
        sim, _, _, _ = solve(1, 2 ** 33 + 7, n_adaptive_cycles=3)
        new = records() - before
    finally:
        gc.enable()
    assert new == {id(sim.forest.dofs_of(1))}
