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
            "ssor": lambda m, A, f, ld: (TSm.HostSSOR(A, 0.5) if m is TSm
                                         else m.make_ssor_host(A, 0.5)),
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
    s = TSm.HostSSOR(A, 0.5)
    with TimerOutput().run() as tr:
        s(t64(np.ones(A.n_rows)))
        s(t64(np.ones(A.n_rows)))
    run = tr.summarize()
    ssor = run["spans"]["smoother.ssor_host"]
    assert ssor["calls"] == 2 and ssor["total_s"] > 0.0
    assert run["counters"]["run"]["host_reads"] == 2
    assert run["counters"]["run"]["uploads"] == 2


def test_cpu_levels_keep_the_host_ssor(hier):
    """On the CPU ``build_gmg(smoother="ssor")`` and ``gmg_from_jax`` build
    the scipy sweep: a V-cycle opens 4 spans ``smoother.ssor_host`` a
    smoothed level and none of the card sweep."""
    tg = hier["tg"]
    again = gmg_from_jax(gmg_leaves(hier["jg"]), "cpu", smoother="ssor")
    smoothed = [s for s in tg.smoothers if s is not None]
    for g in (tg, again):
        assert all(isinstance(s.precond, TSm.HostSSOR)
                   for s in g.smoothers if s is not None)
    assert len(smoothed) == len(tg.matrices) - 1
    assert isinstance(TSm.make_ssor(tg.matrices[-1]), TSm.HostSSOR)
    g = np.random.default_rng(4).standard_normal(tg.n_dofs)
    with TimerOutput().run() as tr:
        tg(t64(g))
    run = tr.summarize()
    assert run["spans"]["smoother.ssor_host"]["calls"] == 4 * len(smoothed)
    assert "smoother.ssor" not in run["spans"]
    assert "ssor_card_calls" not in run["counters"]["run"]


def test_card_ssor_operands_on_the_cpu(hier):
    """The card sweep's operands, prepared from a CPU CSR: the int32
    pattern equal to the CSR's, its diagonal, the polled vectors all
    ``NOT_YET`` and zeroed tickets; an application off the card raises."""
    A = hier["tg"].matrices[-1]
    s = TSm.CardSSOR(A, 0.5)
    assert s.indptr.dtype == s.indices.dtype == torch.int32
    np.testing.assert_array_equal(s.indptr.numpy(), A.indptr)
    np.testing.assert_array_equal(s.indices.numpy(), A.indices)
    assert torch.equal(s.diag, A.diagonal())
    assert bool((s.diag > 0).all())
    assert s.yp.dtype == s.y1.dtype == s.z.dtype == torch.float64
    assert s.yp.shape == s.y1.shape == s.z.shape == (A.n_rows,)
    for v in (s.yp, s.z):
        assert bool((v.view(torch.int64) == TSm.NOT_YET).all())
        assert bool(v.isnan().all())
    assert s.tickets.tolist() == [0, 0]
    before = TSm.ssor_sweep.launches
    with pytest.raises(ValueError, match="CUDA card"):
        s(t64(np.ones(A.n_rows)))
    assert TSm.ssor_sweep.launches == before


@pytest.mark.parametrize("fault, error, match", [
    ("defect_float32", TypeError, "float32/float64"),
    ("values_int64", TypeError, "float32/float64"),
    ("pattern_int64", TypeError, "int32 pattern"),
    ("y1_float32", TypeError, "float64 yp, y1"),
    ("defect_short", ValueError, "shapes"),
    ("indices_short", ValueError, "shapes"),
    ("tickets_three", ValueError, "shapes"),
    ("defect_strided", ValueError, "contiguous"),
])
def test_ssor_sweep_checks_its_operands(hier, fault, error, match):
    """What the kernel does not take raises before any launch, on the CPU
    as on the card."""
    A = hier["tg"].matrices[-1]
    s = TSm.CardSSOR(A, 0.5)
    n = A.n_rows
    ops = dict(indptr=s.indptr, indices=s.indices, vals=A.data,
               diag=s.diag, r=t64(np.ones(n)), omega=0.5, yp=s.yp, y1=s.y1,
               z=s.z, tickets=s.tickets)
    change = {
        "defect_float32": ("r", lambda t: t.float()),
        "values_int64": ("vals", lambda t: t.long()),
        "pattern_int64": ("indptr", lambda t: t.long()),
        "y1_float32": ("y1", lambda t: t.float()),
        "defect_short": ("r", lambda t: t[:-1]),
        "indices_short": ("indices", lambda t: t[:-1]),
        "tickets_three": ("tickets", lambda t: torch.zeros(3, dtype=t.dtype)),
        "defect_strided": ("r", lambda t: torch.ones(2 * n,
                                                     dtype=t.dtype)[::2]),
    }[fault]
    ops[change[0]] = change[1](ops[change[0]])
    with pytest.raises(error, match=match):
        TSm.ssor_sweep(**ops)


def test_ssor_chain_depths(hier):
    """The SSOR sweep's dependency chains (roofline.chain_depths): a
    tridiagonal matrix's are its size both ways; a level matrix's pattern
    is symmetric, so both sweeps are equally deep."""
    from coulomb_gmg_tpu_torch.roofline import chain_depths
    n = 7
    cols = [[j for j in (i - 1, i, i + 1) if 0 <= j < n] for i in range(n)]
    indptr = np.cumsum([0] + [len(c) for c in cols])
    assert chain_depths(indptr, np.concatenate(cols)) == (n, n)
    assert chain_depths(np.arange(n + 1), np.arange(n)) == (1, 1)
    A = hier["tg"].matrices[-1]
    fwd, bwd = chain_depths(A.indptr, A.indices)
    assert fwd == bwd > 1


def test_card_ssor_takes_square_matrices(hier):
    """A rectangular matrix, or a column that is no row (on which a warp of
    the kernel would wait forever), raises before anything reaches the
    card."""
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    P = hier["tg"].prolongations[-1]
    with pytest.raises(ValueError, match="square"):
        TSm.CardSSOR(P, 0.5)
    A = hier["tg"].matrices[-1]
    for bad in (-1, A.n_rows):
        cols = A.indices.copy()
        cols[len(cols) // 2] = bad
        with pytest.raises(ValueError, match="outside the rows"):
            TSm.CardSSOR(CSR.from_pattern(A.indptr, cols, A.data), 0.5)


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
