"""ELL SpMV of the PyTorch port (ops/ell.py) against the JAX gather form
``solver/tpu_gmg.py:_ell_mv_t`` on stencil-built level operators, float64,
rel 1e-12; the sliced layout of CSR-built operators (slots in CSR order,
its plain product the padded one's bits, and JAX's ``ell_matvec`` on the
JAX ``ELL.from_csr`` to rel 1e-12 in float64, 1e-6 in float32: one float32
rounding a product and a sum); plus the wrapper's device dispatch (plain
version for CPU tensors only, no fall back for CUDA tensors)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.ops.ell import ELL as JELL, ell_matvec
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.ops.stencil import (build_level_ops, level_topology,
                                         stencil_table)
from coulomb_gmg_tpu.solver.tpu_gmg import _ell_mv_t
from coulomb_gmg_tpu_torch.ops.ell import (ELL, SLICE, SlicedELL, Slices,
                                           ell_mv, ell_mv_cuda, ell_mv_plain)
from torch_parity import adaptive_forest, random_csr, rel_err, t64

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def level_ops():
    """JAX-built (cols, evals, if_vals, ifT_vals) of every level of a
    refined 3D forest, as numpy."""
    f = adaptive_forest(3)
    dofs = f.dofs_of(1)
    T = jnp.asarray(stencil_table(3, element_tables(3, 1, 2)))
    out = []
    for l, ld in enumerate(dofs.levels):
        t = level_topology(f, ld, l)
        cols, evals, _, if_vals, ifT_vals = build_level_ops(
            jnp.asarray(t.coords), jnp.asarray(t.mask8), jnp.asarray(t.elim),
            jnp.asarray(t.iface), jnp.asarray(t.boundary), t.n, T, dim=3,
            side=t.side, h=t.h, want_iface=True, np_dtype=jnp.float64)
        out.append(tuple(np.asarray(a) for a in
                         (cols, evals, if_vals, ifT_vals)))
    return out


@pytest.mark.parametrize("which", ["A", "if", "ifT"])
def test_ell_plain_matches_jax_gather(level_ops, which):
    rng = np.random.default_rng(0)
    for cols, evals, if_vals, ifT_vals in level_ops:
        vals = {"A": evals, "if": if_vals, "ifT": ifT_vals}[which]
        x = rng.standard_normal(cols.shape[1])
        ref = np.asarray(_ell_mv_t(jnp.asarray(cols), jnp.asarray(vals),
                                   jnp.asarray(x)))
        out = ell_mv(t64(cols).to(torch.int32), t64(vals), t64(x)).numpy()
        if np.abs(ref).max() == 0:
            assert not out.any()
        else:
            assert rel_err(out, ref) < 1e-12


def test_ell_cpu_dispatch_is_plain_and_not_counted(level_ops):
    cols, evals = (t64(a) for a in level_ops[-1][:2])
    cols = cols.to(torch.int32)
    x = t64(np.random.default_rng(1).standard_normal(cols.shape[1]))
    before = ell_mv.launches
    assert torch.equal(ell_mv(cols, evals, x), ell_mv_plain(cols, evals, x))
    assert ell_mv.launches == before


def test_ell_cuda_path_never_falls_back(level_ops):
    cols, evals = (t64(a) for a in level_ops[-1][:2])
    x = t64(np.ones(cols.shape[1]))
    with pytest.raises(ValueError):
        ell_mv_cuda(cols.to(torch.int32), evals, x)     # CPU operands
    with pytest.raises(TypeError):
        ell_mv_cuda(cols.long(), evals, x)              # int64 cols


@pytest.mark.parametrize("fault, error, match", [
    ("x dtype", TypeError, "dtypes"),
    ("cols int64", TypeError, "int32"),
    ("shape", ValueError, "shapes"),
    ("strided cols", ValueError, "contiguous"),
    ("none", ValueError, "on the card"),
])
def test_ell_cuda_wrapper_checks_raise_on_cpu_tensors(level_ops, fault,
                                                       error, match):
    cols, vals = (t64(a) for a in level_ops[-1][:2])
    cols = cols.to(torch.int32)
    x = t64(np.ones(cols.shape[1]))
    if fault == "x dtype":
        x = x.float()
    elif fault == "cols int64":
        cols = cols.long()
    elif fault == "shape":
        vals = vals[:, :-1]
    elif fault == "strided cols":
        cols = torch.cat([cols, cols], 1)[:, ::2]
    with pytest.raises(error, match=match):
        ell_mv_cuda(cols, vals, x)


@pytest.mark.parametrize("pad", [0, 13])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 3000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sliced_ell_from_csr(dtype, n, pad):
    """The sliced layout of a random CSR (``pad_rows_to`` = n + pad): every
    row's entries in CSR order, then padding (value 0, column 0) to its
    slice's width; the plain product equals the padded plain product bit
    for bit, and JAX's ``ell_matvec`` to rel 1e-12 / 1e-6."""
    indptr, indices, data = random_csr(n, dtype, seed=n + pad)
    e = SlicedELL.from_csr(indptr, indices, data, pad_rows_to=n + pad)
    counts = np.diff(indptr)
    n_sl = -(-(n + pad) // SLICE)
    lens = np.zeros(n_sl * SLICE, np.int64)
    lens[:n] = counts
    width = lens.reshape(n_sl, SLICE).max(1)
    assert e.n_rows == n + pad and e.width == counts.max() == 51
    assert np.array_equal(np.diff(e.off), SLICE * width)
    assert e.cols.dtype == np.int32 and e.vals.dtype == dtype
    for r in range(n_sl * SLICE):
        s, j = divmod(r, SLICE)
        slots = e.off[s] + SLICE * np.arange(width[s]) + j
        m = lens[r]
        src = slice(indptr[r], indptr[r] + m) if r < n else slice(0, 0)
        assert np.array_equal(e.cols[slots[:m]], indices[src])
        assert np.array_equal(e.vals[slots[:m]], data[src])
        assert not e.cols[slots[m:]].any() and not e.vals[slots[m:]].any()

    x = np.random.default_rng(n).standard_normal(n).astype(dtype)
    sl, vals = e.device("cpu")
    assert isinstance(sl, Slices) and sl.width == 51
    padded = ELL.from_csr(indptr, indices, data,
                          pad_rows_to=n + pad).device("cpu")
    assert all(torch.equal(a, b) for a, b in zip(sl.padded(vals), padded))
    y = ell_mv(sl, vals, torch.from_numpy(x))
    assert y.dtype == vals.dtype and y.shape == (n + pad,)
    assert torch.equal(y, ell_mv_plain(*padded, torch.from_numpy(x)))
    je = JELL.from_csr(indptr, indices, data, pad_rows_to=n + pad)
    ref = np.asarray(ell_matvec(jnp.asarray(je.cols), jnp.asarray(je.vals),
                                jnp.asarray(x)))
    assert rel_err(y.numpy(), ref) < (1e-12 if dtype == np.float64
                                      else 1e-6)


@pytest.mark.parametrize("n, pad", [(9, 0), (3000, 5)])
def test_sliced_ell_from_coo_keeps_each_rows_order(n, pad):
    """Shuffled COO entries: each row keeps the order its entries come in
    (a stable sort by row), as ``ELL.from_coo`` does."""
    indptr, indices, data = random_csr(n, np.float64, seed=3)
    rowids = np.repeat(np.arange(n), np.diff(indptr))
    order = np.random.default_rng(4).permutation(len(rowids))
    e = SlicedELL.from_coo(rowids[order], indices[order], data[order], n,
                           pad_rows_to=n + pad)
    p = ELL.from_coo(rowids[order], indices[order], data[order], n,
                     pad_rows_to=n + pad)
    sl, vals = e.device("cpu")
    assert all(torch.equal(a, b)
               for a, b in zip(sl.padded(vals), p.device("cpu")))


@pytest.mark.parametrize("fault, error, match", [
    ("x dtype", TypeError, "dtypes"),
    ("cols int64", TypeError, "int32"),
    ("shape", ValueError, "shapes"),
    ("offsets", ValueError, "slices of"),
    ("none", ValueError, "on the card"),
])
def test_sliced_ell_cuda_wrapper_checks_raise_on_cpu_tensors(fault, error,
                                                             match):
    indptr, indices, data = random_csr(33, np.float64, seed=5)
    sl, vals = SlicedELL.from_csr(indptr, indices, data).device("cpu")
    x = t64(np.ones(33))
    if fault == "x dtype":
        x = x.float()
    elif fault == "cols int64":
        sl = Slices(sl.off, sl.cols.long(), sl.n_rows, sl.width)
    elif fault == "shape":
        vals = vals[:-1]
    elif fault == "offsets":
        sl = Slices(sl.off[:-1], sl.cols, sl.n_rows, sl.width)
    before = ell_mv.launches
    with pytest.raises(error, match=match):
        ell_mv_cuda(sl, vals, x)
    assert ell_mv.launches == before
