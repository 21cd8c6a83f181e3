"""The GMG solve of the PyTorch port (solver/gmg.py, solver/device_gmg.py,
convert.py) against the JAX StencilGMG on one refined forest with hanging
nodes and inhomogeneous Dirichlet values, float64.

Tolerances: DST coarse apply rel 1e-10; cellwise matvec rel 1e-12; RHS
rel 1e-12 against the JAX package's host assembly (not against the JAX
``_rhs_device``, which is ~2^-24 off on boundary-adjacent rows); a full
solve takes the same CG count with solutions within rel 1e-8; on the
converted JAX operator set the first V-cycle (one CG step) agrees to
rel 1e-12 and the iteration counts agree."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.fem.assembly import assemble_np, build_plan
from coulomb_gmg_tpu.fem.integrals import rhs_cells_np, stiffness_cells_np
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.solver.tpu_gmg import (_coarse_apply, _fused_gmg_cg,
                                            cellwise_mv as jax_cellwise_mv)
from coulomb_gmg_tpu_torch.convert import operators_from_jax
from coulomb_gmg_tpu_torch.solver.gmg import (cellwise_mv, coarse_apply,
                                              gmg_cg)
from torch_parity import (jax_stencil_gmg, padded, refined_problem, rel_err,
                          t64, torch_stencil_gmg)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problem():
    f, dofs, con, rho, tab = refined_problem(seed=0)
    gj = jax_stencil_gmg(f, dofs, con)
    gt = torch_stencil_gmg(f, dofs, con)
    plan = build_plan(dofs.cell2dof, con)
    h = f.cell_h()
    K = stiffness_cells_np(element_tables(3, 1, 2), h)
    _, rhs = assemble_np(plan, K, rhs_cells_np(tab, h, rho))
    return dict(f=f, dofs=dofs, con=con, rho=rho, tab=tab, gj=gj, gt=gt,
                rhs=rhs, plan=plan, K=K)


def test_hierarchy_has_hanging_nodes(problem):
    assert len(problem["dofs"].hanging_pairs[0]) > 0
    assert len(problem["gt"].ops["levels"]) == 3


def test_dst_coarse_apply_matches_jax(problem):
    gj, gt = problem["gj"], problem["gt"]
    n0 = gt.ops["levels"][0]["inv_diag"].shape[0] - 1
    d = np.random.default_rng(3).standard_normal(n0)
    inv_j = gj.levels[0]["inv_diag"]
    ref = np.asarray(_coarse_apply(
        gj.dst_S, gj.dst_lam, jnp.asarray(padded(d, inv_j.shape[0])), inv_j,
        gj.dst_interior, gj.dst_inv_map, gj.dst_int_mask, gj.dst_bnd_mask,
        gj.dst_shape))[:n0]
    out = coarse_apply(gt.ops["dst"], t64(padded(d, n0 + 1)),
                       gt.ops["levels"][0]["inv_diag"], 3).numpy()[:n0]
    assert rel_err(out, ref) < 1e-10


def test_cellwise_mv_matches_jax(problem):
    gj, gt = problem["gj"], problem["gt"]
    n = gt.n
    v = np.random.default_rng(4).standard_normal(n)
    ref = np.asarray(jax_cellwise_mv(gj._sys_dev,
                                     jnp.asarray(padded(v, gj.n_pad))))[:n]
    out = cellwise_mv(gt.ops["sys"], t64(padded(v, gt.n_pad))).numpy()[:n]
    assert rel_err(out, ref) < 1e-12
    # the float64 operand set of the defect is the same operator
    out64 = cellwise_mv(gt.sys64, t64(padded(v, gt.n_pad))).numpy()[:n]
    assert rel_err(out64, ref) < 1e-12


def test_rhs_matches_host_assembly(problem):
    gt, rho = problem["gt"], problem["rho"]
    r = torch.zeros(gt.C_pad, rho.shape[1], dtype=torch.float64)
    r[: len(rho)] = t64(rho)
    out = gt.assemble_rhs(r, problem["tab"]).numpy()
    assert not out[gt.n:].any()
    assert rel_err(out[: gt.n], problem["rhs"]) < 1e-12


def test_defect_is_the_assembled_residual(problem):
    """b - A x on the device in float64 equals the host CSR residual."""
    gt = problem["gt"]
    plan, K = problem["plan"], problem["K"]
    data, _ = assemble_np(plan, K)
    x = np.random.default_rng(5).standard_normal(gt.n)
    x[problem["con"].rows] = 0.0
    gt.b64 = t64(padded(problem["rhs"], gt.n_pad))
    Ax = np.zeros(gt.n)
    rows = np.repeat(np.arange(gt.n), np.diff(plan.pattern.indptr))
    np.add.at(Ax, rows, data * x[plan.pattern.indices])
    ref = problem["rhs"] - Ax
    ref[problem["con"].rows] = 0.0
    out = gt.defect64(t64(padded(x, gt.n_pad))).numpy()[: gt.n]
    assert rel_err(out, ref) < 1e-12


def test_solve_matches_jax(problem):
    gj, gt, rhs = problem["gj"], problem["gt"], problem["rhs"]
    x_ref, k_ref, _, res_ref = gj.solve(rhs, rtol=1e-8)
    x, k, _, res = gt.solve(t64(padded(rhs, gt.n_pad)), rtol=1e-8)
    assert k == k_ref
    assert res <= 1e-8 * np.linalg.norm(rhs) * 1.01
    assert rel_err(x.numpy()[: gt.n], x_ref) < 1e-8


def test_converted_operators_reproduce_jax_vcycle(problem):
    gj, rhs = problem["gj"], problem["rhs"]
    tree = gj._fused_tree()
    ops = operators_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    b = padded(rhs, gj.n_pad)
    flat, treedef = jax.tree_util.tree_flatten(tree)

    def jax_cg(tol, maxiter):
        return _fused_gmg_cg(jnp.asarray(b), jnp.zeros(gj.n_pad),
                             np.asarray(tol), np.asarray(0.0), flat,
                             treedef=treedef, degree=4,
                             dst_shape=gj.dst_shape, coarse_maxiter=500,
                             maxiter=maxiter)

    # one CG step from zero: x1 = alpha * V(b), the first V-cycle output
    x1_ref, _ = jax_cg(0.0, 1)
    x1, k1, _, _ = gmg_cg(ops, t64(b), torch.zeros(gj.n_pad), 0.0, 1)
    assert k1 == 1
    assert rel_err(x1.numpy(), np.asarray(x1_ref)) < 1e-12
    tol = 1e-8 * np.linalg.norm(rhs)
    _, stats = jax_cg(tol, 100)
    _, k, _, _ = gmg_cg(ops, t64(b), torch.zeros(gj.n_pad), tol, 100)
    assert k == int(np.asarray(stats)[0])
