"""The Solve's check (solver/check.py:card_check) on the CPU, where its
kernels run their plain versions: every cycle of the 8- and 64-atom
float64 host-assembled runs and of the 8-atom device-operator runs, held
to the numpy formulas the driver used before the check moved to the
device (kept here as the reference), to ``fem/constraints.py:distribute``
and to scipy's residual; a pattern without one mirror raises; one
``check_card_calls``, one span ``check.card`` and one host read a cycle."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from coulomb_gmg_tpu_torch import driver
from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.fem.constraints import distribute
from coulomb_gmg_tpu_torch.mesh.dofs import Constraints
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.ell import SlicedELL, ell_mv
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.solver import check
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from coulomb_gmg_tpu_torch.utils.timer import RUNS

torch.set_num_threads(2)

RUNS_OF = {
    "f64_8_atoms": (1, 3, dict(dtype="float64")),
    "f64_64_atoms": (2, 2, dict(dtype="float64")),
    "device_ops_8_atoms": (1, 3, dict(dtype="float32",
                                      solver_backend="tpu_cg")),
    "device_ops_f64_8_atoms": (1, 2, dict(dtype="float64",
                                          device_operators="on",
                                          solver_backend="tpu_cg")),
}


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module", params=sorted(RUNS_OF))
def cycles(request):
    """Each cycle's system, solution and check of one whole run on the
    CPU (4 vacuum repetitions), with the run's record."""
    n, n_cycles, kw = RUNS_OF[request.param]
    cfg = production_scaling_config(n, vacuum_repetitions=4,
                                    n_adaptive_cycles=n_cycles, **kw)
    got = []
    real = driver.Simulation._log_solve

    def log_solve(self, b, x, k, res0, resf, system=None, defect=None):
        rec = dict(A=None if self.device_ops else self.A, b=_host(b).copy(),
                   x=_host(x).astype(np.float64), con=self.constraints,
                   defect=None if defect is None else _host(defect).copy())
        rec["residual"] = real(self, b, x, k, res0, resf, system=system,
                               defect=defect)
        rec.update(norms=dict(self.norms), solution=self.solution)
        got.append(rec)
        return rec["residual"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver.Simulation, "_log_solve", log_solve)
        sim = driver.Simulation(cfg, atoms=nacl_lattice(n), device="cpu",
                                pcout=Pcout(enabled=False))
        res = sim.run()
    assert len(got) == n_cycles
    return dict(name=request.param, recs=got, res=res, run=RUNS[-1],
                device_ops=sim.device_ops)


def parent_matrix_norms(A: CSR) -> dict:
    """The driver's numpy matrix norms before the check moved."""
    absd = np.abs(A.data_np()).astype(np.float64)
    colsum = np.bincount(A.indices, weights=absd, minlength=A.n_cols)
    return {"l1_mat": float(colsum.max()),
            "linf_mat": float(np.add.reduceat(absd, A.indptr[:-1]).max()),
            "fro_mat": float(np.sqrt((absd ** 2).sum()))}


def parent_vector_norms(b, x) -> dict:
    """The driver's numpy vector norms before the check moved."""
    return {"l1_rhs": float(np.abs(b).sum()),
            "l2_rhs": float(np.linalg.norm(b)),
            "linf_rhs": float(np.abs(b).max()),
            "l1_sol": float(np.abs(x).sum()),
            "l2_sol": float(np.linalg.norm(x)),
            "linf_sol": float(np.abs(x).max())}


def rel(a, b):
    return abs(a - b) / abs(b)


def test_norms_are_the_numpy_norms(cycles):
    """``l1_mat`` to the bit (np.bincount's order), the other norms within
    1e-13 relative; no matrix norms without an assembled matrix."""
    for r in cycles["recs"]:
        want = parent_vector_norms(r["b"], r["x"])
        for k, v in want.items():
            assert rel(r["norms"][k], v) <= 1e-13, (k, r["norms"][k], v)
        if r["A"] is None:
            assert all(r["norms"][k] is None for k in check._MAT)
            continue
        mat = parent_matrix_norms(r["A"])
        assert r["norms"]["l1_mat"] == mat["l1_mat"]
        for k in ("linf_mat", "fro_mat"):
            assert rel(r["norms"][k], mat[k]) <= 1e-13, (k, r["norms"][k])


def test_distributed_solution_is_the_host_distribute(cycles):
    """The card distribution against ``fem/constraints.py:distribute``
    (one ``np.dot`` a row) within 1e-15 of max |x|; the free rows are x's
    own bits."""
    for r in cycles["recs"]:
        want = distribute(r["con"], r["x"])
        got = r["solution"]
        assert got.dtype == np.float64 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-15 * np.abs(r["x"]).max()
        free = ~r["con"].is_constrained
        assert np.array_equal(got[free], r["x"][free])
        assert len(r["con"].rows) > 0


def test_residual_is_the_true_residual(cycles):
    """The assembled route's residual: the bits of the driver's formula
    before the check moved (the float64 ELL product, then the norm), and
    scipy's ``||b - A x||`` within 1e-13 ||b|| (the residual is 1e-8 of
    ||b||, its entries cancel to that, so two summation orders agree to
    the rounding of b and A x, not to 1e-13 of the residual).  The float64
    device operators': the norm of their defect within 1e-13 relative.
    The refined route's is the refinement's own."""
    for r, res in zip(cycles["recs"], cycles["res"]):
        if r["A"] is not None:
            A = r["A"]
            b, x = torch.from_numpy(r["b"]), torch.from_numpy(r["x"])
            parent = float(torch.linalg.vector_norm(
                b - ell_mv(*A.ell(dtype=torch.float64), x)))
            assert r["residual"] == parent
            want = np.linalg.norm(r["b"] - sp.csr_matrix(
                (A.data_np(), A.indices, A.indptr)) @ r["x"])
            assert abs(r["residual"] - want) <= 1e-13 * np.linalg.norm(
                r["b"])
        elif r["defect"] is not None:
            assert rel(r["residual"], np.linalg.norm(r["defect"])) <= 1e-13
        else:
            assert r["residual"] is None
            assert res["residual"] <= 1.01e-8 * res["l2_rhs"]
            continue
        assert res["residual"] == r["residual"]


def test_one_check_one_read_a_cycle(cycles):
    """One ``check_card_calls`` and one span ``check.card`` a cycle, inside
    ``solve.check``, with one host read; the solution is never read back
    apart from it."""
    run, n = cycles["run"], len(cycles["recs"])
    by_span = run["counters_by_span"]["check.card"]
    assert by_span["check_card_calls"] == n
    assert by_span["host_reads"] == n
    assert run["spans"]["check.card"]["calls"] == n
    assert run["counters"]["Solve"]["check_card_calls"] == n
    assert run["spans"]["solve.check"]["self_s"] < run["spans"][
        "solve.check"]["total_s"]


def _grid_matrix(m: int = 20):
    """The 5-point pattern of an m x m grid (symmetric) with values drawn
    from a seed (not symmetric), as a scipy CSR with sorted columns."""
    lap = sp.kron(sp.eye(m), sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (m, m))) \
        + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (m, m)), sp.eye(m))
    A = sp.csr_matrix(lap)
    A.sort_indices()
    A.data = np.random.default_rng(5).standard_normal(A.nnz)
    return A


def no_constraints(n: int) -> Constraints:
    """A constraint set of n DoFs with no constrained row."""
    return Constraints(rows=np.zeros(0, np.int64),
                       indptr=np.zeros(1, np.int64),
                       cols=np.zeros(0, np.int64), weights=np.zeros(0),
                       inhomog=np.zeros(0), n_dofs=n)


@pytest.mark.parametrize("which", [0, 1, 977, -1])
def test_a_missing_mirror_raises(which):
    """A pattern with one entry removed is not symmetric: the check counts
    the one entry without its mirror and raises, from the first row's
    entry to the last row's; the whole pattern counts none."""
    A = _grid_matrix()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    off = np.flatnonzero(rows != A.indices)
    keep = np.ones(A.nnz, dtype=bool)
    keep[off[which]] = False
    B = sp.csr_matrix((A.data[keep], (rows[keep], A.indices[keep])), (n, n))
    con = no_constraints(n)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(n))
    for M, missing in ((A, 0.0), (B, 1.0)):
        system = SlicedELL.from_csr(M.indptr, M.indices, M.data).device(
            "cpu", torch.float64)
        out = torch.zeros(4, dtype=torch.float64)
        check.matrix_norms(*system, out)
        assert float(out[3]) == missing
    check.card_check(x, x, con, SlicedELL.from_csr(
        A.indptr, A.indices, A.data).device("cpu", torch.float64))
    with pytest.raises(ValueError, match="no mirror"):
        check.card_check(x, x, con, system)


def test_plain_norms_by_hand():
    """A 3 x 3 matrix with a symmetric pattern and unsymmetric values, two
    rows in a slice: column sums over the mirrors, row sums, Frobenius."""
    dense = np.array([[4.0, -1.0, 0.0], [-2.0, 5.0, 3.0], [0.0, 0.5, -6.0]])
    A = sp.csr_matrix(dense)
    sl, vals = SlicedELL.from_csr(A.indptr, A.indices, A.data).device(
        "cpu", torch.float64)
    got = check.matrix_norms_plain(sl, vals).tolist()
    assert got == [np.abs(dense).sum(0).max(), np.abs(dense).sum(1).max(),
                   np.sqrt((dense ** 2).sum()), 0.0]


def test_plain_distribute_by_hand():
    """Two constrained rows, one of them Dirichlet (no entries): inhomog
    plus the weighted sum in CSR order; every other row kept."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], dtype=torch.float64)
    ints = torch.tensor([1, 3, 0, 2, 2, 0, 4], dtype=torch.int32)
    floats = torch.tensor([0.5, 0.25, 0.1, -7.0], dtype=torch.float64)
    out = x.clone()
    check.distribute_rows(ints, floats, 2, x, out)
    assert out.tolist() == [1.0, 0.1 + (0.5 * 1.0 + 0.25 * 5.0), 3.0, -7.0,
                            5.0]
