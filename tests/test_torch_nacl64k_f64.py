"""The published 64,000-atom run's configuration (``nacl64k_f64``: float64,
GMG-CG with the SSOR smoother, the float64 host-assembled route) through
the harness's ``Solver``, against the plain float64 reference of the
benchmark (gmg_bench/reference/), on seeded atom orders of the 8- and
64-atom lattices; and the spans and counters that the cell of that
configuration reads.

The meshes keep 4 vacuum repetitions instead of the study's 10, so that a
whole run takes a second or two on the CPU; the program and the reference
read the same settings, so the comparison is unchanged by it."""

import dataclasses

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch import driver
from coulomb_gmg_tpu_torch.config import Config, production_scaling_config
from coulomb_gmg_tpu_torch.utils.timer import RUNS
from gmg_bench import cells, check, inputs
from gmg_bench.control import control_snapshots
from gmg_bench.run import Solver

CELL = cells.find_cell("nacl64k_f64.production")


def settings(n: int) -> dict:
    """The configuration file's settings on the ``8 n^3``-atom lattice,
    4 vacuum repetitions, 2 cycles."""
    return dict(CELL.config["settings"], domain_right=float(n),
                vacuum_repetitions=4, n_adaptive_cycles=2)


@pytest.fixture(scope="module", params=[1, 2], ids=["8_atoms", "64_atoms"])
def solved(request):
    """A whole run of the lattice in an order drawn from a seed: its
    record, snapshots, atoms, settings, the run's summary and the level
    GMGs it built."""
    n = request.param
    s = settings(n)
    order = inputs.Orders(2 ** 35 + 101 * n, 8 * n ** 3).next()
    built = []

    def build_gmg(*a, **k):
        built.append(plain_build(*a, **k))
        return built[-1]

    plain_build = driver.build_gmg
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "build_gmg", build_gmg)
        rec, snaps, atoms = Solver(s, "cpu").solve(n, order, snap=True)
    return dict(rec=rec, snaps=snaps, atoms=atoms, settings=s,
                run=RUNS[-1], gmgs=built)


def judge(d, snaps):
    return check.compare(snaps, d["atoms"].positions, d["atoms"].charges,
                         d["settings"], None, CELL.limits, 0, "cpu",
                         seed=7, readers=CELL.checks)


def test_the_configuration_is_the_published_run_uncut():
    cfg = CELL.config
    ref = production_scaling_config(20, dtype="float64")
    got = Config(**dict(cfg["settings"], lammps_file=ref.lammps_file))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert (got.dtype, got.solver_backend, got.smoother) == (
        "float64", "auto", "ssor")
    assert (got.smoother_damping, got.smoother_steps) == (0.5, 2)
    assert cfg["lattice"]["n"] == 20 and cfg["lattice"]["atoms"] == 64000
    assert cfg["published_cells"] == [1728000, 1728560, 1749672, 1785904,
                                      1849296]
    entry = next(c for c in cells.load_benchmark()["configs"]
                 if c["name"] == "nacl64k_f64")
    assert entry["reduced"] == []


def test_a_whole_run_is_correct(solved):
    assert all(r <= 1.01 * solved["settings"]["cg_rtol"]
               for r in solved["rec"]["residual"])
    checks, correct = judge(solved, solved["snaps"])
    assert correct, checks
    assert checks["residual_max"]["value"] < 1e-8
    assert checks["dof_mismatch"]["value"] == 0


def test_the_float32_control_is_not_correct(solved):
    d = solved
    ctl, _ = control_snapshots(d["snaps"], d["atoms"].positions,
                               d["atoms"].charges, d["settings"],
                               torch.float32, "cpu", maxiter=2000)
    checks, correct = judge(d, ctl)
    assert not correct
    assert checks["residual_max"]["value"] > CELL.limits["residual_max"]


def test_the_run_traces_what_the_cell_reads(solved):
    r, gmgs = solved["run"], solved["gmgs"]
    assert r["cells"] == solved["rec"]["cells"]
    coarse = sum(c.get("coarse_cg_iterations", 0)
                 for c in r["counters"].values())
    assert len(gmgs) == 2
    assert coarse == sum(sum(g.coarse_iterations) for g in gmgs) > 0
    assert r["spans"]["solve.coarse"]["calls"] == sum(
        len(g.coarse_iterations) for g in gmgs)
    back = sum(c.get("readback_bytes", 0) for c in r["counters"].values())
    assert back > 0
    assert sum(c.get("readbacks", 0) for c in r["counters"].values()) > 0
    assert r["spans"]["ell.host_build"]["calls"] > 0
    # the system's values come back once a cycle for its host build
    assert r["counters_by_span"]["ell.host_build"]["readback_bytes"] > 0
    assert np.isfinite(r["spans"]["ell.host_build"]["total_s"])
