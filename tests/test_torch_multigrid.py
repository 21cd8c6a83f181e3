"""The level-matrix GMG of the PyTorch port (solver/multigrid.py,
ops/smoothers.py, solver/cg.py, convert.py:gmg_from_jax) against the JAX
package on the same meshes, float64: level, interface and prolongation
matrices and copy maps equal; every smoother and MGSmoother rel 1e-12; one
V-cycle rel 1e-12; preconditioned CG with the same iteration counts.
Products run through ``ell_mv``'s plain version (CPU tensors)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.models import problems as JP
from coulomb_gmg_tpu.ops import smoothers as JSm
from coulomb_gmg_tpu.solver.cg import cg as jcg
from coulomb_gmg_tpu.solver.multigrid import build_gmg as jbuild_gmg
from coulomb_gmg_tpu_torch.convert import gmg_from_jax, gmg_leaves
from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.models import problems as TP
from coulomb_gmg_tpu_torch.ops import smoothers as TSm
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.solver.cg import cg as tcg
from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
from coulomb_gmg_tpu_torch.utils.timer import TimerOutput
from torch_parity import adaptive_forest, jax_forest, rel_err, t64

torch.set_num_threads(2)

MESHES = ["box3d", "cube2d"]


def _mesh(name):
    if name == "box3d":                 # GaussianCharges-like: base box
        return adaptive_forest(3, reps=4, cycles=2, seed=1), None
    f = Forest.hyper_cube(2, 0.0, 1.0, 3)   # Step16: coefficient jump
    c = f.cell_lower() + 0.5 * f.cell_h()[:, None]
    f = f.refine(np.linalg.norm(c - 0.3, axis=1) < 0.3)
    return f.refine(np.linalg.norm(f.cell_lower() - 0.3, axis=1) < 0.2), \
        "step16"


@pytest.fixture(scope="module", params=MESHES)
def hier(request):
    f, coeff = _mesh(request.param)
    dofs = f.dofs_of(1)
    tab = element_tables(f.dim, 1, 2)
    jf = jax_forest(f)
    jg = jbuild_gmg(jf, jf.dofs_of(1), tab, coeff_fn=(JP.step16_coefficient if coeff
                                            else None),
                    smoother="ssor", dtype=jnp.float64)
    tg = build_gmg(f, dofs, tab, coeff_fn=(TP.step16_coefficient if coeff
                                           else None),
                   smoother="ssor", dtype=torch.float64, device="cpu")
    con = build_constraints(dofs, None)
    return dict(f=f, dofs=dofs, jg=jg, tg=tg, con=con, jf=jf)


def test_hierarchy_matrices_equal_jax(hier):
    jg, tg = hier["jg"], hier["tg"]
    assert len(tg.matrices) == len(jg.matrices) >= 3
    assert any(I is not None for I in tg.interfaces)
    for kind in ("matrices", "interfaces", "prolongations"):
        for l, (a, b) in enumerate(zip(getattr(tg, kind),
                                       getattr(jg, kind))):
            assert (a is None) == (b is None), (kind, l)
            if a is None:
                continue
            assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
            np.testing.assert_array_equal(a.indptr, b.indptr)
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
    for a, b in zip(tg.copy_global + tg.copy_level,
                    jg.copy_global + jg.copy_level):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smoother", ["jacobi", "ssor", "mc_ssor",
                                      "chebyshev"])
def test_smoothers_match_jax(hier, smoother):
    l = len(hier["tg"].matrices) - 1
    A_t, A_j = hier["tg"].matrices[l], hier["jg"].matrices[l]
    ld = hier["dofs"].levels[l]
    jld = hier["jf"].dofs_of(1).levels[l]
    make = {"jacobi": lambda m, A, f, ld: m.make_jacobi(A, 0.6),
            "ssor": lambda m, A, f, ld: m.make_ssor_host(A, 0.5),
            "mc_ssor": lambda m, A, f, ld: m.make_mc_ssor(
                A, m.lattice_color(f, ld), 0.5),
            "chebyshev": lambda m, A, f, ld: m.make_chebyshev(A)}[smoother]
    pt = make(TSm, A_t, hier["f"], ld)
    pj = make(JSm, A_j, hier["jf"], jld)
    rng = np.random.default_rng(2)
    r, u = rng.standard_normal((2, A_t.n_rows))
    assert rel_err(pt(t64(r)).numpy(), np.asarray(pj(jnp.asarray(r)))) \
        < 1e-12
    st = TSm.MGSmoother(A=A_t, precond=pt, steps=2)
    sj = JSm.MGSmoother(A=A_j, precond=pj, steps=2)
    assert rel_err(st.apply(t64(r)).numpy(),
                   np.asarray(sj.apply(jnp.asarray(r)))) < 1e-12
    assert rel_err(st.smooth(t64(u), t64(r)).numpy(),
                   np.asarray(sj.smooth(jnp.asarray(u), jnp.asarray(r)))) \
        < 1e-12
    np.testing.assert_array_equal(TSm.lattice_color(hier["f"], ld),
                                  JSm.lattice_color(hier["jf"], jld))


def test_host_ssor_counts_its_applications(hier):
    """Each application: one span ``smoother.ssor_host`` of the run, one
    counted host read of the defect and one counted upload back."""
    A = hier["tg"].matrices[-1]
    s = TSm.make_ssor_host(A, 0.5)
    with TimerOutput().run() as tr:
        s(t64(np.ones(A.n_rows)))
        s(t64(np.ones(A.n_rows)))
    run = tr.summarize()
    ssor = run["spans"]["smoother.ssor_host"]
    assert ssor["calls"] == 2 and ssor["total_s"] > 0.0
    assert run["counters"]["run"]["host_reads"] == 2
    assert run["counters"]["run"]["uploads"] == 2


@pytest.mark.parametrize("source", ["build_gmg", "gmg_from_jax"])
def test_vcycle_matches_jax(hier, source):
    jg = hier["jg"]
    tg = (hier["tg"] if source == "build_gmg"
          else gmg_from_jax(gmg_leaves(jg), "cpu", smoother="ssor"))
    g = np.random.default_rng(3).standard_normal(jg.n_dofs)
    ref = np.asarray(jg(jnp.asarray(g)))
    assert rel_err(tg(t64(g)).numpy(), ref) < 1e-12
    assert tg.coarse_iterations
    with TimerOutput().run() as tr:
        tg(t64(g))
    coarse = tr.summarize()["spans"]["solve.coarse"]
    assert coarse["calls"] == 1 and coarse["total_s"] > 0.0


def test_gmg_leaves_round_trip(hier):
    leaves = gmg_leaves(hier["tg"])
    again = gmg_leaves(gmg_from_jax(leaves, "cpu", smoother="none"))
    for kind in ("matrices", "interfaces", "prolongations"):
        for a, b in zip(leaves[kind], again[kind]):
            assert (a is None) == (b is None)
            if a is not None:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def _system(hier):
    """The global system matrix of the hierarchy's mesh (homogeneous
    Dirichlet values), assembled by the JAX host code, in both CSRs."""
    from coulomb_gmg_tpu.fem.assembly import assemble_np, build_plan
    from coulomb_gmg_tpu.fem.integrals import stiffness_cells_np
    from coulomb_gmg_tpu.ops.spmv import CSR as JCSR
    from coulomb_gmg_tpu_torch.ops.density import cell_quad_points
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    f, dofs = hier["f"], hier["dofs"]
    tab = element_tables(f.dim, 1, 2)
    coeff = None
    if f.dim == 2:
        pts = cell_quad_points(f, tab.points)
        coeff = np.asarray(JP.step16_coefficient(jnp.asarray(pts)))
    plan = build_plan(dofs.cell2dof, hier["con"])
    data, _ = assemble_np(plan, stiffness_cells_np(tab, f.cell_h(), coeff),
                          None)
    return (JCSR.from_pattern(plan.pattern.indptr, plan.pattern.indices,
                              jnp.asarray(data)),
            CSR.from_pattern(plan.pattern.indptr, plan.pattern.indices, data,
                             device="cpu"))


@pytest.mark.parametrize("precond", ["gmg", "jacobi", "none"])
def test_cg_iterations_match_jax(hier, precond):
    A_j, A_t = _system(hier)
    if precond == "gmg":
        pj, pt = hier["jg"], hier["tg"]
    elif precond == "jacobi":
        pj, pt = JSm.make_jacobi(A_j, 0.6), TSm.make_jacobi(A_t, 0.6)
    else:
        pj = pt = None
    b = np.random.default_rng(5).standard_normal(A_t.n_rows)
    b[hier["con"].rows] = 0.0
    tol = 1e-8 * np.linalg.norm(b)
    rj = jcg(A_j.matvec, jnp.asarray(b), precond=pj, tol=tol, maxiter=400,
             host=True)
    rt = tcg(A_t.matvec, t64(b), precond=pt, tol=tol, maxiter=400)
    assert rt.iterations == int(rj.iterations) > 0
    assert abs(rt.initial_residual / float(rj.initial_residual) - 1) < 1e-12
    assert rel_err(rt.x.numpy(), np.asarray(rj.x)) < 1e-8
    # a residual already under the tolerance gives 0 iterations
    again = tcg(A_t.matvec, t64(b), x0=rt.x, precond=pt, tol=tol * 10,
                maxiter=400)
    assert again.iterations == 0
