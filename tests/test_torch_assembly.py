"""Host assembly of the PyTorch port (fem/integrals.py, fem/assembly.py) and
its CSR (ops/spmv.py, ops/ell.py) against the JAX package on the same
refined mesh with hanging nodes and inhomogeneous Dirichlet values:
element integrals and assembled data / rhs rel 1e-12, plans and ELL
layouts equal, CSR products (through ``ell_mv``'s plain version) rel
1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.fem import assembly as JA
from coulomb_gmg_tpu.fem import integrals as JI
from coulomb_gmg_tpu.models import problems as JP
from coulomb_gmg_tpu.ops import spmv as JS
from coulomb_gmg_tpu.ops.ell import ELL as JELL
from coulomb_gmg_tpu_torch.fem import assembly as TA
from coulomb_gmg_tpu_torch.fem import integrals as TI
from coulomb_gmg_tpu_torch.ops.density import cell_quad_points
from coulomb_gmg_tpu_torch.ops.ell import ELL as TELL
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from torch_parity import refined_problem, rel_err, t64

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prob():
    f, dofs, con, rho, tab_rhs = refined_problem(seed=3)
    tab_lap = element_tables(3, 1, 2)
    pts = cell_quad_points(f, tab_lap.points)
    coeff = np.asarray(JP.step16_coefficient(jnp.asarray(pts)))
    plan_j = JA.build_plan(dofs.cell2dof, con)
    plan_t = TA.build_plan(dofs.cell2dof, con)
    K = JI.stiffness_cells_np(tab_lap, f.cell_h(), coeff)
    F = JI.rhs_cells_np(tab_rhs, f.cell_h(), rho)
    return dict(f=f, con=con, rho=rho, tab_lap=tab_lap, tab_rhs=tab_rhs,
                coeff=coeff, plan_j=plan_j, plan_t=plan_t, K=K, F=F,
                jdata=JA.assemble_np(plan_j, K, F))


@pytest.mark.parametrize("with_coeff", [False, True])
def test_element_integrals_match_jax(prob, with_coeff):
    h, tab = prob["f"].cell_h(), prob["tab_lap"]
    c = prob["coeff"] if with_coeff else None
    ref = JI.stiffness_cells_np(tab, h, c)
    assert rel_err(TI.stiffness_cells_np(tab, h, c), ref) < 1e-12
    ref_j = np.asarray(JI.stiffness_cells(tab, jnp.asarray(h), c))
    out = TI.stiffness_cells(tab, t64(h), t64(c) if with_coeff else None)
    assert rel_err(out.numpy(), ref_j) < 1e-12
    ref_f = JI.rhs_cells_np(prob["tab_rhs"], h, prob["rho"])
    assert rel_err(TI.rhs_cells_np(prob["tab_rhs"], h, prob["rho"]),
                   ref_f) < 1e-12
    out_f = TI.rhs_cells(prob["tab_rhs"], t64(h), t64(prob["rho"]))
    assert rel_err(out_f.numpy(), ref_f) < 1e-12


def test_plan_matches_jax(prob):
    pj, pt = prob["plan_j"], prob["plan_t"]
    assert prob["con"].rows.size and len(pj.md_cell)   # dirty cells exist
    for name in ("clean_idx", "r_dof_clean", "m_pos", "md_cell", "md_i",
                 "md_j", "md_w", "d_cell", "d_i", "d_pos", "d_dof", "d_g",
                 "dirty_idx", "rd_cell", "rd_i", "rd_w", "rd_dof",
                 "gd_local"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name),
                                      err_msg=name)
    np.testing.assert_array_equal(pt.pattern.indptr, pj.pattern.indptr)
    np.testing.assert_array_equal(pt.pattern.indices, pj.pattern.indices)
    rows = np.repeat(np.arange(pt.pattern.n_rows), np.diff(pt.pattern.indptr))
    np.testing.assert_array_equal(pt.pattern.pos_of(rows, pt.pattern.indices),
                                  np.arange(pt.pattern.nnz))


def test_assemble_np_matches_jax(prob):
    data, rhs = TA.assemble_np(prob["plan_t"], prob["K"], prob["F"])
    jdata, jrhs = prob["jdata"]
    assert rel_err(data, jdata) < 1e-12
    assert rel_err(rhs, jrhs) < 1e-12


@pytest.mark.parametrize("product", ["matvec", "matvec_T", "diagonal"])
def test_csr_products_match_jax(prob, product):
    pat = prob["plan_t"].pattern
    data = prob["jdata"][0]
    A_j = JS.CSR.from_pattern(pat.indptr, pat.indices, jnp.asarray(data))
    A_t = CSR.from_pattern(pat.indptr, pat.indices, data, device="cpu")
    x = np.random.default_rng(4).standard_normal(pat.n_rows)
    if product == "matvec":
        ref, out = A_j.matvec(jnp.asarray(x)), A_t.matvec(t64(x))
    elif product == "matvec_T":
        ref = JS.csr_matvec_T(A_j.rowids, A_j.indices, A_j.data,
                              jnp.asarray(x), A_j.n_cols)
        out = A_t.matvec_T(t64(x))
    else:
        ref, out = A_j.diagonal(), A_t.diagonal()
    assert rel_err(out.numpy(), np.asarray(ref)) < 1e-12
    assert (A_t.to_scipy() != A_j.to_scipy()).nnz == 0


def test_transposed_csr_and_rectangular_products():
    """A rectangular matrix (a prolongation's shape): products with it and
    its transpose against scipy, and a row-padded ELL."""
    import scipy.sparse as sp
    S = sp.random(40, 17, density=0.2, format="csr",
                  random_state=np.random.default_rng(5))
    A = CSR.from_pattern(S.indptr, S.indices, S.data, n_cols=17,
                         device="cpu")
    x = np.random.default_rng(6).standard_normal(17)
    y = np.random.default_rng(7).standard_normal(40)
    assert rel_err(A.matvec(t64(x)).numpy(), S @ x) < 1e-12
    assert rel_err(A.matvec_T(t64(y)).numpy(), S.T @ y) < 1e-12
    cols, vals = A.ell(n_pad=41)
    assert cols.shape == vals.shape == (int(np.diff(S.indptr).max()), 41)
    assert not vals[:, 40].any()


@pytest.mark.parametrize("form", ["csr", "coo"])
def test_ell_conversion_matches_jax(prob, form):
    pat = prob["plan_t"].pattern
    data = prob["jdata"][0]
    rowids = np.repeat(np.arange(pat.n_rows), np.diff(pat.indptr))
    if form == "csr":
        ej = JELL.from_csr(pat.indptr, pat.indices, data, pad_rows_to=
                           pat.n_rows + 3, pad_k_to=32)
        et = TELL.from_csr(pat.indptr, pat.indices, data, pad_rows_to=
                           pat.n_rows + 3, pad_k_to=32)
    else:
        order = np.random.default_rng(8).permutation(len(rowids))
        ej = JELL.from_coo(rowids[order], pat.indices[order], data[order],
                           pat.n_rows)
        et = TELL.from_coo(rowids[order], pat.indices[order], data[order],
                           pat.n_rows)
    assert (et.n_rows, et.n_cols, et.K) == (ej.n_rows, ej.n_cols, ej.K)
    np.testing.assert_array_equal(et.cols, ej.cols)
    np.testing.assert_array_equal(et.vals, ej.vals)
    cols, vals = et.device("cpu")
    assert cols.dtype == torch.int32 and cols.shape == (et.K, et.n_rows)
