"""The device solve routes of the host-assembled path (solver/tpu_gmg.py,
solver/tpu_cg.py) against the JAX package in float32: ``TpuGMG`` V-cycle
and solve against JAX ``TpuGMG(device=None)`` (rel 1e-5, CG +-1), with
the exact DST coarse solve (unit coefficient on a base box) and with the
Chebyshev-CG coarse solve (Step16 coefficient on a hyper-cube);
``solve_refined`` to a true float64 ``1e-8 * ||b||``; ``tpu_cg_solve``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.models import problems as JP
from coulomb_gmg_tpu.ops.spmv import CSR as JCSR
from coulomb_gmg_tpu.solver import tpu_gmg as JT
from coulomb_gmg_tpu.solver.multigrid import build_gmg as jbuild_gmg
from coulomb_gmg_tpu.solver.tpu_cg import tpu_cg_solve as jtpu_cg_solve
from coulomb_gmg_tpu_torch.fem.assembly import assemble_np, build_plan
from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
from coulomb_gmg_tpu_torch.fem.integrals import stiffness_cells_np
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.models import problems as TP
from coulomb_gmg_tpu_torch.ops.density import cell_quad_points
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.solver import tpu_gmg as TT
from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
from coulomb_gmg_tpu_torch.solver.tpu_cg import tpu_cg_solve
from torch_parity import adaptive_forest, jax_forest, rel_err

torch.set_num_threads(2)


def _mesh(name):
    if name == "dst":
        return adaptive_forest(3, reps=4, cycles=2, seed=2)
    f = Forest.hyper_cube(3, 0.0, 1.0, 2)
    c = f.cell_lower() + 0.5 * f.cell_h()[:, None]
    return f.refine(np.linalg.norm(c - 0.3, axis=1) < 0.35)


@pytest.fixture(scope="module", params=["dst", "cg"])
def route(request):
    f = _mesh(request.param)
    step16 = request.param == "cg"
    dofs = f.dofs_of(1)
    tab = element_tables(3, 1, 2)
    con = build_constraints(dofs, None)
    coeff = None
    if step16:
        pts = cell_quad_points(f, tab.points)
        coeff = np.asarray(JP.step16_coefficient(jnp.asarray(pts)))
    plan = build_plan(dofs.cell2dof, con)
    data, _ = assemble_np(plan, stiffness_cells_np(tab, f.cell_h(), coeff,
                                                   dtype=np.float32),
                          None, dtype=np.float32)
    pat = plan.pattern
    jf = jax_forest(f)
    jg = jbuild_gmg(jf, jf.dofs_of(1), tab,
                    coeff_fn=(JP.step16_coefficient if step16 else None),
                    smoother="none", dtype=jnp.float32)
    tg = build_gmg(f, dofs, tab, coeff_fn=(TP.step16_coefficient if step16
                                           else None),
                   smoother="none", dtype=torch.float32, device="cpu")
    A_j = JCSR.from_pattern(pat.indptr, pat.indices, jnp.asarray(data))
    A_t = CSR.from_pattern(pat.indptr, pat.indices, data, device="cpu")
    jt = JT.TpuGMG(jg, A_j, jf, device=None, dtype=jnp.float32,
                   use_dst=not step16)
    tt = TT.TpuGMG(tg, A_t, f, "cpu", dtype=torch.float32,
                   use_dst=not step16)
    b = np.random.default_rng(7).standard_normal(pat.n_rows)
    b[con.rows] = 0.0
    return dict(jt=jt, tt=tt, A_t=A_t, pat=pat, data=data, b=b,
                dst=not step16)


def test_coarse_route_is_the_one_asked_for(route):
    assert (route["tt"].ops["dst"] is not None) == route["dst"]
    assert (route["jt"].dst is not None) == route["dst"]


def test_vcycle_matches_jax(route):
    jt, tt = route["jt"], route["tt"]
    n = tt.n
    g = np.zeros(jt.n_pad, np.float32)
    g[:n] = route["b"]
    ref = np.asarray(jt.vcycle(jnp.asarray(g)))[:n]
    gp = torch.zeros(tt.n_pad, dtype=torch.float32)
    gp[:n] = torch.from_numpy(g[:n])
    assert rel_err(tt.vcycle(gp)[:n].numpy(), ref) < 1e-5


def test_solve_matches_jax(route):
    xj, kj, r0j, rj = route["jt"].solve(route["b"], None, rtol=1e-6,
                                        maxiter=100, fused=False)
    xt, kt, r0t, rt = route["tt"].solve(route["b"], None, rtol=1e-6,
                                        maxiter=100)
    assert abs(kt - kj) <= 1 and kt > 0
    assert abs(r0t / r0j - 1) < 1e-5
    assert rel_err(xt.numpy(), xj) < 1e-5


def test_solve_refined_reaches_float64_target(route):
    pat, data, b = route["pat"], route["data"], route["b"]
    xj, kj, _, rj = JT.solve_refined(route["jt"], pat.indptr, pat.indices,
                                     data, b, rtol=1e-8, maxiter=100,
                                     fused=False)
    xt, kt, r0t, rt = TT.solve_refined(route["tt"], route["A_t"], b,
                                       rtol=1e-8, maxiter=100)
    nb = np.linalg.norm(b)
    assert rt <= 1e-8 * nb and rj <= 1e-8 * nb
    assert abs(r0t / nb - 1) < 1e-12           # x0 = 0
    assert abs(kt - kj) <= 2
    assert xt.dtype == np.float64 and rel_err(xt, xj) < 1e-6
    # a warm start that already meets the target takes no iteration
    x2, k2, r02, _ = TT.solve_refined(route["tt"], route["A_t"], b, xt,
                                      rtol=1e-8, maxiter=100)
    assert k2 == 0 and r02 == pytest.approx(rt, rel=1e-9)


def test_tpu_cg_solve_matches_jax(route):
    pat, data, b = route["pat"], route["data"], route["b"]
    rowids = np.repeat(np.arange(pat.n_rows), np.diff(pat.indptr))
    xj, kj, r0j, rj = jtpu_cg_solve(rowids, pat.indices, data, b, rtol=1e-5,
                                    maxiter=2000, device=None,
                                    dtype=jnp.float32)
    xt, kt, r0t, rt = tpu_cg_solve(rowids, pat.indices, data, b, rtol=1e-5,
                                   maxiter=2000, device="cpu")
    assert 0 < kt < 2000 and abs(kt - kj) <= max(1, kj // 50)
    assert abs(r0t / r0j - 1) < 1e-5
    assert rel_err(xt, xj) < 1e-4
