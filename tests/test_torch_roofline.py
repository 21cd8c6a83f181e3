"""The work counts behind each kernel's bound (coulomb_gmg_tpu_torch/
roofline.py) and the cuSPARSE yardstick of chip_smoke.py, on the CPU at
small sizes: the counts are those of the inputs, not of a worst case."""

import numpy as np
import pytest
import torch

import chip_smoke
from coulomb_gmg_tpu_torch import roofline
from coulomb_gmg_tpu_torch.ops import density as dd, ell, gradient as gr
from coulomb_gmg_tpu_torch.ops import stencil, tile_density as td
from coulomb_gmg_tpu_torch.ops.neighbors import atom_lists
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from torch_parity import CUT, R_C, adaptive_forest, tile_setup

torch.set_num_threads(2)


@pytest.mark.parametrize("ops, n_bytes, by", [
    (67e9, 1.0, "operations"), (1.0, 3.35e9, "bytes")])
def test_bound_is_the_larger_time(ops, n_bytes, by):
    b = roofline.bound(ops, n_bytes)
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(1.0)


def test_tile_terms_are_the_members_of_the_uniform_mesh():
    """On an unrefined mesh each cell is its own level-0 ancestor, so the
    member terms are n_q times the host atom lists' pairs."""
    f, atoms, tab = tile_setup(1, 3, None)
    plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                              atoms.charges, CUT, n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, tab.points, plan, R_C, CUT, "cpu")
    kw["n_out"] = f.n_cells + 1
    out = td.tile_density_plain(*args, **kw)
    b = roofline.tile_density(args, kw, out)
    _, want = atom_lists(f, atoms.positions, CUT)
    assert b["terms"] == len(tab.points) * int(want.sum()) > 0
    assert b["ops"] == roofline.OPS_DENSITY * b["terms"]
    assert b["bytes"] == sum(t.numel() * t.element_size()
                             for t in (*args, out))


@pytest.mark.parametrize("r_c", [R_C, 0.3])
def test_gradient_near_pairs_are_counted(r_c):
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.0, 3.0, (300, 3))
    pts = rng.uniform(-1.0, 4.0, (2000, 3)).astype(np.float32)
    A = dd.pack_atoms(pos, rng.choice([-1.0, 1.0], 300), "cpu")
    b = roofline.exact_gradient(torch.from_numpy(pts), A, gr.far_r2(r_c))
    d = pts[:, None, :] - pos.astype(np.float32)[None]
    near = int(((d * d).sum(-1) < np.float32(gr.far_r2(r_c))).sum())
    assert b["near"] == near > 0
    assert b["ops"] == (roofline.OPS_GRAD_FAR * (600000 - near)
                        + roofline.OPS_GRAD_NEAR * near)


def test_ell_bound_and_csr_yardstick():
    f = adaptive_forest(3)
    ld = f.dofs_of(1).levels[-1]
    t = stencil.level_topology(f, ld, len(f.dofs_of(1).levels) - 1)
    T = torch.from_numpy(stencil.stencil_table(3, element_tables(3, 1, 2)))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cols, vals, _ = stencil.build_level_ops(
        put(t.coords), put(t.mask8), put(t.elim), put(t.iface),
        put(t.boundary), t.n, T, dim=3, side=t.side, h=t.h,
        want_iface=False, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        t.n).astype(np.float32))
    csr = chip_smoke.ell_as_csr(cols, vals)
    assert csr.values().numel() == int((vals != 0).sum())
    y = ell.ell_mv_plain(cols, vals, x)
    assert float((torch.mv(csr, x) - y).abs().max()) <= 1e-6 * float(
        y.abs().max())
    b = roofline.ell_spmv(cols, vals, x)
    nnz = int((vals != 0).sum())
    assert b["terms"] == nnz < cols.numel()
    assert b["ops"] == 2 * nnz
    assert b["bytes"] == 8 * nnz + 8 * t.n


def test_ell_bound_is_the_same_for_both_layouts():
    """The bound counts the nonzero slots: the padded and the sliced
    layout of one CSR-built operator do the same work."""
    import scipy.sparse as sp
    from coulomb_gmg_tpu_torch.ops.ell import ELL, SlicedELL
    S = sp.random(300, 300, density=0.05, format="lil",
                  random_state=np.random.default_rng(9))
    S[7, :120] = 1.0                 # one long row in a short slice
    S = S.tocsr()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(300))
    padded = ELL.from_csr(S.indptr, S.indices, S.data).device("cpu")
    sliced = SlicedELL.from_csr(S.indptr, S.indices, S.data).device("cpu")
    assert sliced[0].cols.numel() < padded[0].numel()
    bp, bs = roofline.ell_spmv(*padded, x), roofline.ell_spmv(*sliced, x)
    assert bp == bs and bs["terms"] == S.nnz
    assert bs["bytes"] == 12 * S.nnz + 16 * 300


@pytest.mark.parametrize("r_c", [R_C, 0.05])
def test_dense_density_counts_the_pairs_whose_exp_is_not_zero(r_c):
    """Pairs past r^2 / r_c^2 ~ 104 add exact zeros and are not counted:
    with a narrow r_c most pairs are such."""
    f, atoms, tab = tile_setup(1, 3, None)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, r_c, "cpu")
    out = dd.dense_density_plain(*args, n_out=f.n_cells + 1, **kw)
    b = roofline.dense_density(args, kw, out)
    lower, h, pref, A = (a.numpy() for a in args)
    p = (lower[:, None, :] + h[:, None, None] * pref).reshape(-1, 1, 3)
    d = p - A[None, :, :3]
    r2 = (d * d).sum(-1)
    live = int((np.exp(-r2 * np.float32(kw["inv_rc2"])) != 0).sum())
    assert b["pairs"] == r2.size
    assert b["terms"] == live > 0
    assert (live < r2.size) == (r_c < R_C)
    assert b["ops"] == roofline.OPS_DENSITY * live


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_list_density_counts_the_entries_its_cells_read(dtype):
    """Each cell of a refined mesh reads its cycle-0 ancestor's row: the
    entries are the carried lists' counts (more than the rows hold); an
    entry costs dim * n1 factors and n1^dim terms, twice in float64."""
    from coulomb_gmg_tpu_torch.adapt.transfer import old_cell_of_new
    from coulomb_gmg_tpu_torch.mesh.forest import to_host
    from coulomb_gmg_tpu_torch.ops.neighbors import locality_lists
    f0, atoms, tab = tile_setup(1, 2, None)
    f1 = f0.refine(np.random.default_rng(2).random(f0.n_cells) < 0.1)
    lists0 = locality_lists(f0, atoms.positions, CUT)
    lists = lists0.carried(to_host(old_cell_of_new(f0, f1)))
    t = torch.from_numpy
    x1 = dd._tensor_rule_1d(tab.points, 3)
    args = (t(lists.ptr), t(lists.atoms), t(lists.home), t(f1.level),
            t(f1.ijk), t(x1).to(dtype),
            dd.pack_atoms(atoms.positions, atoms.charges, "cpu", dtype))
    out = torch.zeros(f1.n_cells + 1, len(tab.points), dtype=dtype)
    b = roofline.list_density(args, dict(dim=3, n_rows=f1.n_cells), out)
    entries = int(lists.counts.sum())
    assert b["terms"] == entries > int(lists0.counts.sum())
    per = 4 * 3 * len(x1) + 4 * len(tab.points)
    assert b["ops"] == per * entries * (2 if dtype == torch.float64 else 1)
    assert b["bytes"] > 4 * entries + out.numel() * out.element_size()
