"""ELL SpMV of the PyTorch port (ops/ell.py) against the JAX gather form
``solver/tpu_gmg.py:_ell_mv_t`` on stencil-built level operators, float64,
rel 1e-12; plus the wrapper's device dispatch (plain version for CPU
tensors only, no fall back for CUDA tensors)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.ops.stencil import (build_level_ops, level_topology,
                                         stencil_table)
from coulomb_gmg_tpu.solver.tpu_gmg import _ell_mv_t
from coulomb_gmg_tpu_torch.ops.ell import ell_mv, ell_mv_cuda, ell_mv_plain
from torch_parity import adaptive_forest, rel_err, t64

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
