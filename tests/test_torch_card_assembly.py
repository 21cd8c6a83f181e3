"""The device CSR assembly (fem/card_assembly.py) against the JAX package's
host engine (``build_plan`` + ``assemble_np``, coulomb_gmg_tpu/fem/
assembly.py): the pattern equal, the values and the
load vector within 1e-13 relative in float64 (the host's threaded sums
and its numpy element integrals round apart) and 1e-6 in float32 (the
float64 sums rounded to float32 on both sides, the load's element
integrals in float32 by torch and by numpy), and two calls equal to the
bit.  Meshes: the refined problem of tests/test_torch_assembly.py with
the Step16 coefficient (hanging nodes, inhomogeneous Dirichlet values) and
the 8-atom float64 production run's meshes after one refinement (unit
coefficient, the dipole far field on the boundary).  Matrices: the system
with and without its load vector, the finest level matrix under the level
eliminations and its interface matrix.  On the CPU the plain segment sum
runs, held to the JAX package's engine (imported in those cases alone);
the ``cuda`` cases run the same on the card with the hand kernel, held to
the plain version's bits on the CPU, and on the 1,000-atom float64 run
check its trajectory and the engine's memory.  The ``cuda`` cases import
no JAX; on a card machine:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_card_assembly.py
"""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.fem import card_assembly as CA
from coulomb_gmg_tpu_torch.fem.integrals import rhs_cells
from coulomb_gmg_tpu_torch.mesh.dofs import Constraints
from coulomb_gmg_tpu_torch.models import problems as P
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.density import cell_quad_points
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import refined_problem, rel_err

torch.set_num_threads(2)

MATRICES = ["system", "system_rhs", "level", "interface"]
TOL = {torch.float64: 1e-13, torch.float32: 1e-6}
# tests/test_production_trajectory.py:38, SSOR_run.o876223
REF_CELLS_1000 = [216000, 216560, 222552, 233584, 253296]
REF_CG_1000 = [1, 6, 7, 8, 8]
BUDGET = 256 * 2 ** 20      # the engine's own device bytes, at most


def _refined():
    f, dofs, con, rho, tab_rhs = refined_problem(seed=3)
    pts = cell_quad_points(f, element_tables(3, 1, 2).points)
    coeff = P.step16_coefficient(torch.from_numpy(pts)).numpy()
    return f, con, rho, tab_rhs, coeff


def _sim8():
    cfg = production_scaling_config(1, dtype="float64", n_adaptive_cycles=1)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    sim.run()
    sim.refine()           # a mesh with hanging nodes, its constraints
    return (sim.forest, sim.constraints, sim.rho[: sim.forest.n_cells].numpy(),
            sim.tab_rhs, None)


@pytest.fixture(scope="module", params=["refined", "sim8"])
def mesh(request):
    return {"refined": _refined, "sim8": _sim8}[request.param]()


def _level_set(edge, bnd) -> Constraints:
    """The level eliminations as a host constraint set."""
    rows = np.flatnonzero(edge | bnd).astype(np.int64)
    return Constraints(rows=rows, indptr=np.zeros(len(rows) + 1, np.int64),
                       cols=np.zeros(0, np.int64), weights=np.zeros(0),
                       inhomog=np.zeros(len(rows)), n_dofs=len(edge))


def _case(mesh, matrix, dev, dtype, use_jax):
    """(reference (indptr, indices, data, rhs) in ``dtype``: JAX's host
    engine with ``use_jax``, else the plain version on the CPU; card
    callable giving the same from ``dev``)."""
    f, con, rho, tab_rhs, coeff = mesh
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    tab = element_tables(3, 1, 2)
    if matrix.startswith("system"):
        c2d, h, cset = f.dofs_of(1).host.cell2dof, f.cell_h(), con
        cq = coeff
        ccon = lambda dev: CA.card_constraints(con, dev)
    else:
        ld = f.dofs_of(1).host.levels[-1]
        edge, bnd = ld.interface, ld.boundary
        c2d = ld.cell2dof
        if matrix == "interface":
            c2d = c2d[edge[c2d].any(1)]
            cset = _level_set(np.zeros_like(edge), np.zeros_like(bnd))
        else:
            cset = _level_set(edge, bnd)
        h = f.h(ld.level) * np.ones(len(c2d))
        cq = None
        elim = (edge | bnd) if matrix == "level" else np.zeros_like(edge)
        ccon = lambda dev: CA.eliminated(torch.from_numpy(elim).to(dev))
    want_rhs = matrix == "system_rhs"

    def card(dev=dev):
        hd = torch.from_numpy(h).to(dev)
        keep = None
        if matrix == "interface":
            e, bn = (torch.from_numpy(edge).to(dev),
                     torch.from_numpy(bnd).to(dev))
            keep = lambda r, c: e[r] & ~e[c] & ~bn[r] & ~bn[c]
        p = CA.plan(torch.from_numpy(c2d).to(dev), ccon(dev), rhs=want_rhs,
                    keep=keep)
        k = CA.cell_matrices(tab, hd, cq, dtype)
        fc = None
        if want_rhs:
            fc = rhs_cells(tab_rhs, hd, torch.from_numpy(rho).to(dev),
                           dtype=dtype)
        d, b = CA.assemble(p, k, fc, dtype)
        return (p.pattern.indptr, p.pattern.indices, d.cpu().numpy(),
                None if b is None else b.cpu().numpy())

    if not use_jax:
        return card(torch.device("cpu")), card
    from coulomb_gmg_tpu.fem.assembly import assemble_np, build_plan
    from coulomb_gmg_tpu.fem.integrals import rhs_cells_np, stiffness_cells_np
    plan = build_plan(c2d, cset)
    F = rhs_cells_np(tab_rhs, h, rho, dtype=np_dtype) if want_rhs else None
    data, rhs = assemble_np(plan, stiffness_cells_np(tab, h, cq,
                                                     dtype=np_dtype), F,
                            dtype=np_dtype)
    if matrix == "interface":
        r = np.repeat(np.arange(plan.pattern.n_rows),
                      np.diff(plan.pattern.indptr))
        c = plan.pattern.indices
        data = np.where(edge[r] & ~edge[c] & ~bnd[r] & ~bnd[c], data,
                        0.0).astype(np_dtype)
    return (plan.pattern.indptr, plan.pattern.indices, data, rhs), card


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_card_assembly_matches_host(mesh, matrix, dtype, device):
    dev = _device(device)
    (indptr, indices, data, rhs), card = _case(mesh, matrix, dev, dtype,
                                               use_jax=dev.type == "cpu")
    assert mesh[1].rows.size and len(indices)
    before = CA.segment_sum.launches
    got = card()
    np.testing.assert_array_equal(got[0], indptr)
    np.testing.assert_array_equal(got[1], indices)
    assert got[2].dtype == data.dtype
    assert rel_err(got[2], data) < TOL[dtype]
    if rhs is None:
        assert got[3] is None
    else:
        assert got[3].dtype == rhs.dtype
        assert rel_err(got[3], rhs) < TOL[dtype]
    again = card()
    for a, b in zip(got[2:], again[2:]):
        assert (a is None and b is None) or np.array_equal(a, b)
    if dev.type == "cuda":
        # the kernel ran, a sum for the matrix and one for the load, and
        # summed the matrix to the plain version's bits
        assert CA.segment_sum.launches == before + 2 * (1 + (rhs is not None))
        np.testing.assert_array_equal(got[2], data)


@pytest.mark.cuda
def test_card_route_1000_atoms():
    """The float64 route at 1,000 atoms on the card: the published cells,
    the CG counts of the host engine's run, the true residual, and every
    matrix built with at most ``BUDGET`` device bytes above what was live
    when its plan or its values began."""
    dev = _device("cuda")
    marks = []

    def watched(fn):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            marks.append(torch.cuda.max_memory_allocated(dev) - base)
            return out
        return run

    plan, assemble = CA.plan, CA.assemble
    CA.plan, CA.assemble = watched(plan), watched(assemble)
    try:
        sim = Simulation(production_scaling_config(5, dtype="float64"),
                         atoms=nacl_lattice(5), device=dev,
                         pcout=Pcout(enabled=False))
        res = sim.run()
    finally:
        CA.plan, CA.assemble = plan, assemble
    assert [r["n_cells"] for r in res] == REF_CELLS_1000
    assert [r["cg_iterations"] for r in res] == REF_CG_1000
    assert all(r["residual"] <= 1.01e-8 * r["l2_rhs"] for r in res)
    assert marks and max(marks) <= BUDGET, max(marks)
    print(f"engine high-water: {max(marks)} B over {len(marks)} calls")
