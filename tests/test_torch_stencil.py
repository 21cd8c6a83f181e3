"""Device-side operator builds of the PyTorch port (ops/stencil.py) against
the JAX builds on the same refined forests, float64: ELL columns equal,
values rel 1e-12; power iteration rel 1e-10.  (tests/test_stencil_ops.py
ties the JAX builds to host assembly at 1e-12.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.ops import stencil as J
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops import stencil as T
from torch_parity import adaptive_forest, jax_forest, rel_err, t64

torch.set_num_threads(2)


def _close(out, ref, rtol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    if np.abs(ref).max() == 0:
        assert not out.any()
    else:
        assert rel_err(out, ref) < rtol


@pytest.fixture(scope="module", params=[2, 3])
def hierarchy(request):
    dim = request.param
    f = jax_forest(adaptive_forest(dim))
    dofs = f.dofs_of(1)
    tab = element_tables(dim, 1, 2)
    topos = [J.level_topology(f, ld, l) for l, ld in enumerate(dofs.levels)]
    return dim, topos, J.stencil_table(dim, tab)


def test_host_half_is_the_same(hierarchy):
    dim, topos, table = hierarchy
    np.testing.assert_array_equal(T.offset3(dim), J.offset3(dim))
    tab = element_tables(dim, 1, 2)
    np.testing.assert_array_equal(T.stencil_table(dim, tab), table)


def test_level_ops_match_jax(hierarchy):
    dim, topos, table = hierarchy
    saw_iface = False
    for l, t in enumerate(topos):
        ref = J.build_level_ops(
            jnp.asarray(t.coords), jnp.asarray(t.mask8), jnp.asarray(t.elim),
            jnp.asarray(t.iface), jnp.asarray(t.boundary), t.n,
            jnp.asarray(table), dim=dim, side=t.side, h=t.h, want_iface=True,
            np_dtype=jnp.float64)
        out = T.build_level_ops(
            t64(t.coords), t64(t.mask8), t64(t.elim), t64(t.iface),
            t64(t.boundary), t.n, t64(table), dim=dim, side=t.side, h=t.h,
            want_iface=True, dtype=torch.float64)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        for o, r in zip(out[1:], ref[1:]):
            _close(o, r, 1e-12)
        saw_iface |= bool(np.asarray(ref[3]).any())
    assert saw_iface, "the mesh must exercise refinement edges"


def test_prolongation_ops_match_jax(hierarchy):
    dim, topos, _ = hierarchy
    for l in range(1, len(topos)):
        tf, tc = topos[l], topos[l - 1]
        ref = J.build_prolongation_ops(
            jnp.asarray(tf.coords), tf.n, jnp.asarray(tc.coords), tc.n,
            dim=dim, side_c=tc.side, np_dtype=jnp.float64)
        out = T.build_prolongation_ops(
            t64(tf.coords), tf.n, t64(tc.coords), tc.n, dim=dim,
            side_c=tc.side, dtype=torch.float64)
        for k in (0, 2):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        for k in (1, 3):
            _close(out[k], ref[k], 1e-12)


def test_power_lmax_matches_jax(hierarchy):
    dim, topos, table = hierarchy
    t = topos[-1]
    cols, evals, inv_diag = J.build_level_ops(
        jnp.asarray(t.coords), jnp.asarray(t.mask8), jnp.asarray(t.elim),
        jnp.asarray(t.iface), jnp.asarray(t.boundary), t.n,
        jnp.asarray(table), dim=dim, side=t.side, h=t.h, want_iface=False,
        np_dtype=jnp.float64)
    ref = float(J.power_lmax_device(cols, evals, inv_diag, t.n))
    out = float(T.power_lmax_device(t64(cols), t64(evals), t64(inv_diag),
                                    t.n))
    assert abs(out - ref) <= 1e-10 * abs(ref)


def test_padding_rows_are_inert(hierarchy):
    """Pad rows (coords past the lattice) carry zero values and in-range
    columns; real rows are unchanged by padding."""
    dim, topos, table = hierarchy
    t = topos[-1]
    pad = 5
    coords = np.vstack([t.coords, np.full((pad, dim), t.side + 1,
                                          t.coords.dtype)])
    pb = lambda a: t64(np.concatenate([a, np.zeros(pad, a.dtype)]))
    args = dict(dim=dim, side=t.side, h=t.h, want_iface=True,
                dtype=torch.float64)
    cols, evals, _, if_vals, _ = T.build_level_ops(
        t64(coords), pb(t.mask8), pb(t.elim), pb(t.iface), pb(t.boundary),
        t.n, t64(table), **args)
    assert not evals[:, t.n:].any() and not if_vals[:, t.n:].any()
    assert int(cols.min()) >= 0 and int(cols.max()) < t.n + pad
    cols0, evals0, *_ = T.build_level_ops(
        t64(t.coords), t64(t.mask8), t64(t.elim), t64(t.iface),
        t64(t.boundary), t.n, t64(table), **args)
    x = t64(np.random.default_rng(2).standard_normal(t.n + pad))
    y = (evals * x[cols.long()]).sum(0)[: t.n]
    y0 = (evals0 * x[: t.n][cols0.long()]).sum(0)
    assert rel_err(y.numpy(), y0.numpy()) < 1e-12
