"""The stepped solve of the PyTorch port (solver/fused.py, the counterpart
of the one-executable ``_fused_gmg_cg``) against the eager loops it
replaces, and against live JAX runs.

On the CPU every segment of the stepped solve runs eagerly, one call for
each replay the card makes, so these tests run the code that the card
captures as CUDA graphs.  It must give the eager loop's bits: ``torch.equal``
on the solution and equal iteration counts and norms, with the device
operators of the 8-atom production run (DST coarse solve) and with a
Step16 ``TpuGMG`` without the DST (a coarse CG inside every V-cycle), in
float32 and float64, from several starts and on reused state.  Against
JAX (float64):
equal CG counts and solutions within rel 1e-12.  Host reads are counted by
``solver/cg.py:to_host``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.config import golden_gaussian_config as jax_golden
from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
from coulomb_gmg_tpu.models import problems as JP
from coulomb_gmg_tpu.models.atoms import two_atom_pair as jax_pair
from coulomb_gmg_tpu.ops.spmv import CSR as JCSR
from coulomb_gmg_tpu.solver import tpu_gmg as JT
from coulomb_gmg_tpu.solver.multigrid import build_gmg as jbuild_gmg
from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
from coulomb_gmg_tpu_torch.config import (golden_gaussian_config,
                                          production_scaling_config)
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.fem.assembly import assemble_np, build_plan
from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
from coulomb_gmg_tpu_torch.fem.integrals import stiffness_cells_np
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.models import problems as TP
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice, two_atom_pair
from coulomb_gmg_tpu_torch.ops.density import cell_quad_points
from coulomb_gmg_tpu_torch.ops.ell import ELL
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.solver import gmg as G
from coulomb_gmg_tpu_torch.solver import tpu_cg as TC
from coulomb_gmg_tpu_torch.solver.cg import to_host
from coulomb_gmg_tpu_torch.solver.fused import SteppedGMG
from coulomb_gmg_tpu_torch.solver.tpu_gmg import TpuGMG
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import (adaptive_forest, jax_forest, jax_stencil_gmg, padded,
                          refined_problem, rel_err, t64, torch_stencil_gmg)

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
RTOL = {"float32": 1e-6, "float64": 1e-10}


def _step16_system(dtype, box: bool = False):
    """(mesh and assembly data, GMG hierarchy, system CSR, rhs) of the
    Step16 coefficient on a refined hyper-cube (a single base cell, so no
    DST); ``box``: the unit coefficient on a refined 4^3 box, to be solved
    without its DST (a coarse CG of several iterations)."""
    if box:
        f = adaptive_forest(3, reps=4, cycles=2, seed=2)
    else:
        f = Forest.hyper_cube(3, 0.0, 1.0, 2)
        c = f.cell_lower() + 0.5 * f.cell_h()[:, None]
        f = f.refine(np.linalg.norm(c - 0.3, axis=1) < 0.35)
    dofs = f.dofs_of(1)
    tab = element_tables(3, 1, 2)
    con = build_constraints(dofs, None)
    coeff = None if box else np.asarray(JP.step16_coefficient(jnp.asarray(
        cell_quad_points(f, tab.points))))
    plan = build_plan(dofs.cell2dof, con)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    data, _ = assemble_np(plan, stiffness_cells_np(tab, f.cell_h(), coeff,
                                                   dtype=np_dt),
                          None, dtype=np_dt)
    pat = plan.pattern
    hier = dict(f=f, dofs=dofs, tab=tab, pat=pat, data=data)
    from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
    gmg = build_gmg(f, dofs, tab,
                    coeff_fn=None if box else TP.step16_coefficient,
                    smoother="none", dtype=dtype, device="cpu")
    A = CSR.from_pattern(pat.indptr, pat.indices, data, device="cpu")
    b = np.random.default_rng(7).standard_normal(pat.n_rows)
    b[con.rows] = 0.0
    return hier, gmg, A, b


@pytest.fixture(scope="module", params=["float32", "float64"])
def routes(request):
    """Both operator sets in one working type: the device operators of
    the 8-atom production run's cycle 1 (DST; cycle 0 is uniform and
    converges in one step) and a Step16 TpuGMG (coarse CG)."""
    dt = DTYPES[request.param]
    cfg = production_scaling_config(1, dtype=request.param,
                                    device_operators="on",
                                    solver_backend="tpu_cg",
                                    n_adaptive_cycles=2)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    sim.run()
    g = sim.gmg
    out = {"device_ops": dict(ops=g.ops, n_pad=g.n_pad, b=g.b64.to(dt)),
           "name": request.param, "dtype": dt}
    for name, box in (("step16", False), ("box_cg", True)):
        hier, hgmg, A, b = _step16_system(dt, box)
        tg = TpuGMG(hgmg, A, hier["f"], "cpu", dtype=dt, use_dst=False)
        out[name] = dict(ops=tg.ops, n_pad=tg.n_pad, b=tg._padded(b))
    return out


def _both(route, dt, rtol, maxiter=100, x0=None, b=None, st=None):
    """The eager loop and the stepped solve (``st``, else a new one) on the
    same inputs, and the host reads of each."""
    ops, n_pad = route["ops"], route["n_pad"]
    b = route["b"] if b is None else b
    x0 = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * float(torch.linalg.vector_norm(b))
    r0 = to_host.reads
    eager = G.gmg_cg(ops, b, x0, tol, maxiter)
    eager_reads = to_host.reads - r0
    st = SteppedGMG(ops, n_pad, dt, "cpu") if st is None else st
    r0 = to_host.reads
    stepped = st.solve(b, x0, tol, maxiter)
    return eager, stepped, eager_reads, to_host.reads - r0


def _same(eager, stepped):
    assert torch.equal(stepped[0], eager[0])
    assert stepped[1:] == eager[1:]


ROUTES = ["device_ops", "step16", "box_cg"]


@pytest.mark.parametrize("start", ["zero", "half", "reused"])
@pytest.mark.parametrize("which", ROUTES)
def test_stepped_solve_is_the_eager_loop(routes, which, start):
    """torch.equal solutions, equal k, |r0| and |r|: from x0 = 0, from half
    the converged solution, and on the state of a solve of another rhs
    (the card reuses one capture for every refinement pass)."""
    route, dt, rtol = routes[which], routes["dtype"], RTOL[routes["name"]]
    x0, st = None, None
    if start == "half":
        x0 = 0.5 * _both(route, dt, rtol)[0][0]
    elif start == "reused":
        st = SteppedGMG(route["ops"], route["n_pad"], dt, "cpu")
        other = torch.from_numpy(np.random.default_rng(5).standard_normal(
            route["b"].shape[0])).to(dt) * (route["b"] != 0)
        st.solve(other, torch.zeros_like(other),
                 rtol * float(torch.linalg.vector_norm(other)), 100)
    eager, stepped, _, _ = _both(route, dt, rtol, x0=x0, st=st)
    _same(eager, stepped)
    assert eager[1] >= 2
    assert (route["ops"]["dst"] is None) == (which != "device_ops")


@pytest.mark.parametrize("which", ROUTES)
def test_stepped_solve_edge_cases(routes, which):
    """maxiter cuts the solve; a converged x0 gives k == 0; a zero rhs
    gives k == 0 and x == 0 through the 0/0 guard."""
    route, dt, rtol = routes[which], routes["dtype"], RTOL[routes["name"]]
    eager, stepped, _, _ = _both(route, dt, rtol, maxiter=2)
    _same(eager, stepped)
    assert stepped[1] == 2
    x_conv = G.gmg_cg(route["ops"], route["b"], torch.zeros_like(route["b"]),
                      rtol * float(torch.linalg.vector_norm(route["b"])),
                      100)[0]
    eager, stepped, _, _ = _both(route, dt, rtol, x0=x_conv)
    _same(eager, stepped)
    assert stepped[1] == 0
    zero = torch.zeros_like(route["b"])
    eager, stepped, _, _ = _both(route, dt, rtol, b=zero)
    _same(eager, stepped)
    assert stepped[1] == 0 and not stepped[0].any()


@pytest.mark.parametrize("which", ROUTES)
def test_host_reads_per_solve(routes, which, monkeypatch):
    """Eager: k + 1 reads, plus kc + 2 per coarse CG.  Stepped: k + 1 reads
    of ``info``, plus kc + 1 of the coarse flag per coarse CG."""
    kcs = []
    coarse_cg = G.coarse_cg

    def counted(ops, d0):
        r0 = to_host.reads
        out = coarse_cg(ops, d0)
        kcs.append(to_host.reads - r0 - 2)
        return out

    monkeypatch.setattr(G, "coarse_cg", counted)
    eager, stepped, reads, sreads = _both(routes[which], routes["dtype"],
                                          RTOL[routes["name"]])
    _same(eager, stepped)
    k = eager[1]
    if which == "device_ops":
        assert kcs == []
    else:
        assert len(kcs) == k + 1 and min(kcs) >= 1
    if which == "box_cg":
        assert max(kcs) >= 3
    assert reads == k + 1 + sum(kc + 2 for kc in kcs)
    assert sreads == k + 1 + sum(kc + 1 for kc in kcs)


def test_stepped_cheby_cg_is_the_eager_loop(routes):
    """tpu_cg_solve's Chebyshev-Jacobi CG, stepped against solver/cg.py:
    the same bits, k + 1 host reads each; a converged x0 gives k == 0."""
    dt, name = routes["dtype"], routes["name"]
    _, _, A, b = _step16_system(dt)
    rows = np.repeat(np.arange(A.n_rows), np.diff(A.indptr))
    e = ELL.from_coo(rows, A.indices, A.data_np(), A.n_rows,
                     pad_rows_to=A.n_rows + 1)
    cols, vals = e.device("cpu")
    diag = np.ones(A.n_rows + 1)
    diag[: A.n_rows] = A.diagonal().numpy()
    inv_diag = torch.from_numpy(1.0 / diag).to(dt)
    bt = torch.from_numpy(padded(b, A.n_rows + 1)).to(dt)
    tol = RTOL[name] * float(torch.linalg.vector_norm(bt))
    for x0 in (torch.zeros_like(bt), None):
        if x0 is None:
            x0 = eager.x
        r0 = to_host.reads
        eager = TC._cheby_cg(cols, vals, bt, x0, inv_diag, tol, 500)
        reads = to_host.reads - r0
        st = TC.SteppedChebyCG(cols, vals, inv_diag, "cpu")
        r0 = to_host.reads
        stepped = st.solve(bt, x0, tol, 500)
        assert torch.equal(stepped.x, eager.x)
        assert stepped[1:] == eager[1:]
        assert reads == eager.iterations + 1
        assert to_host.reads - r0 == eager.iterations + 1
    assert eager.iterations == 0
    out = [TC.tpu_cg_solve(A.rowids, A.indices, A.data_np(), b,
                           rtol=RTOL[name], maxiter=500, device="cpu",
                           dtype=dt, fused=fused) for fused in (False, True)]
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1:] == out[1][1:]
    assert out[0][1] > 2


def test_solve_fused_routes(monkeypatch):
    """solve_fused=True (the default) takes the stepped solve in StencilGMG
    and TpuGMG, False the eager loop; the results are the same bits."""
    calls = []
    eager = G.gmg_cg
    monkeypatch.setattr("coulomb_gmg_tpu_torch.solver.device_gmg.gmg_cg",
                        lambda *a: calls.append("device") or eager(*a))
    monkeypatch.setattr("coulomb_gmg_tpu_torch.solver.tpu_gmg.gmg_cg",
                        lambda *a: calls.append("tpu") or eager(*a))
    out = {}
    for fused in (True, False):
        for tag, over in (("device", dict(device_operators="on")),
                          ("tpu", dict(device_operators="off",
                                       solver_backend="tpu_cg"))):
            cfg = production_scaling_config(1, dtype="float32",
                                            n_adaptive_cycles=2,
                                            solve_fused=fused, **over)
            sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                             pcout=Pcout(enabled=False))
            res = sim.run()
            out[tag, fused] = (sim.solution, [r["cg_iterations"]
                                              for r in res])
            if tag == "device":
                assert (sim.gmg.stepped is not None) == fused
    assert sorted(set(calls)) == ["device", "tpu"]
    for tag in ("device", "tpu"):
        assert np.array_equal(out[tag, True][0], out[tag, False][0])
        assert out[tag, True][1] == out[tag, False][1]


def test_stencil_gmg_matches_jax():
    """The port's StencilGMG.solve (stepped) against JAX StencilGMG.solve
    (the fused executable), float64: equal k, x within rel 1e-12."""
    f, dofs, con, _, _ = refined_problem(seed=0)
    gj = jax_stencil_gmg(f, dofs, con)
    gt = torch_stencil_gmg(f, dofs, con)
    rhs = np.random.default_rng(11).standard_normal(gt.n)
    rhs[con.rows] = 0.0
    x_ref, k_ref, _, _ = gj.solve(rhs, rtol=1e-10)
    x, k, _, _ = gt.solve(t64(padded(rhs, gt.n_pad)), rtol=1e-10)
    assert gt.stepped is not None
    assert k == k_ref >= 3
    assert rel_err(x.numpy()[: gt.n], x_ref) < 1e-12


@pytest.mark.parametrize("use_dst", [True, False])
def test_tpu_gmg_matches_jax_solve_fused(use_dst):
    """The port's TpuGMG.solve (stepped) against JAX TpuGMG.solve_fused on
    the system of tests/test_fused_solve.py (two charges, 2 cycles), with
    the DST and with its coarse-CG case (use_dst=False, coarse_rtol
    1e-10), float64: equal k, x within rel 1e-12."""
    kw = dict(n_adaptive_cycles=2, flag_output_time=False, mesh_size_h=0.5,
              vacuum_repetitions=4)
    sj = JaxSimulation(jax_golden(**kw), atoms=jax_pair(),
                       pcout=JaxPcout(enabled=False))
    sj.run()
    st = Simulation(golden_gaussian_config(**kw), atoms=two_atom_pair(),
                    device="cpu", pcout=Pcout(enabled=False))
    st.run()
    rhs = np.asarray(sj.rhs)
    assert rel_err(np.asarray(st.rhs), rhs) < 1e-14
    gj = JT.TpuGMG(sj.gmg, sj.A, sj.forest, device=None, dtype=sj.dtype,
                   use_dst=use_dst, coarse_rtol=1e-10)
    x_ref, k_ref, _, _ = gj.solve_fused(rhs, rtol=1e-8)
    gt = TpuGMG(st.gmg, st.A, st.forest, "cpu", dtype=torch.float64,
                use_dst=use_dst, coarse_rtol=1e-10)
    x, k, _, _ = gt.solve(rhs, rtol=1e-8)
    assert (gt.ops["dst"] is None) != use_dst
    assert k == k_ref >= 3
    assert rel_err(x.numpy(), x_ref) < 1e-12


def test_step16_coarse_cg_matches_jax():
    """The coarse-CG route on the Step16 coefficient (single base cell),
    float64, built from the same CSR data in both packages: equal k, x
    within rel 1e-12."""
    hier, hgmg, A, b = _step16_system(torch.float64)
    f, pat = hier["f"], hier["pat"]
    jf = jax_forest(f)
    jg = jbuild_gmg(jf, jf.dofs_of(1), hier["tab"],
                    coeff_fn=JP.step16_coefficient, smoother="none",
                    dtype=jnp.float64)
    A_j = JCSR.from_pattern(pat.indptr, pat.indices,
                            jnp.asarray(hier["data"]))
    jt = JT.TpuGMG(jg, A_j, jf, device=None, dtype=jnp.float64,
                   use_dst=False)
    x_ref, k_ref, _, _ = jt.solve_fused(b, rtol=1e-10)
    tt = TpuGMG(hgmg, A, f, "cpu", dtype=torch.float64, use_dst=False)
    x, k, _, _ = tt.solve(b, rtol=1e-10)
    assert tt.ops["dst"] is None
    assert k == k_ref >= 3
    assert rel_err(x.numpy(), x_ref) < 1e-12


@pytest.mark.parametrize("fails", [False, True])
def test_capture_turns_the_collector_off(fails):
    """Segments._capture runs the captures with the cyclic collector off
    (a collection could reset an earlier solve's graphs in the middle of a
    capture) and turns it on again, also when a capture raises."""
    import gc
    from coulomb_gmg_tpu_torch.solver.fused import Segments
    seen = []

    def capture_all():
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("capture failed")
    seg = Segments({}, "cpu")
    seg._capture_all = capture_all
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            seg._capture()
    else:
        seg._capture()
    assert seen == [False] and gc.isenabled()
