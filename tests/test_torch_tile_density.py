"""Tile density of the PyTorch port (ops/tile_density.py, plain version on
the CPU) against the JAX ``density_locality_tiles(..., interpret=True)``
on the meshes of tests/test_tile_density.py, uniform and refined: the set
of nonzero entries identical, values within atol 2e-6 * max, rtol 2e-5
(that file's own bound); the CSR work plan covers the same (block, tile)
pairs as the TPU plan."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.ops.tile_density import (
    build_tile_plan as jax_plan, density_locality_tiles as jax_tiles)
from coulomb_gmg_tpu_torch.ops import tile_density as td
from torch_parity import CUT, R_C, tile_setup

torch.set_num_threads(2)


@pytest.mark.parametrize("n, vac, refine_seed, a_tile", [
    (1, 3, None, 512), (1, 3, 2, 512), (2, 2, None, 256), (2, 2, 4, 256)])
def test_plain_matches_jax_interpret(n, vac, refine_seed, a_tile):
    f, atoms, tab = tile_setup(n, vac, refine_seed)
    ref = jax_tiles(f, tab.points, atoms.positions, atoms.charges, R_C, CUT,
                    interpret=True, a_tile=a_tile)
    out = td.density_locality_tiles(f, tab.points, atoms.positions,
                                    atoms.charges, R_C, CUT, "cpu",
                                    a_tile=a_tile)
    C = f.n_cells
    assert out.shape == (C + 1, len(tab.points))
    assert not out[C:].any()                   # pad row exactly zero
    out = out[:C].numpy()
    np.testing.assert_array_equal(out != 0, ref != 0)
    np.testing.assert_allclose(out, ref, atol=2e-6 * np.abs(ref).max(),
                               rtol=2e-5)


@pytest.mark.parametrize("refine_seed", [None, 3])
def test_csr_plan_covers_the_tpu_work_list(refine_seed):
    f, atoms, tab = tile_setup(1, 3, refine_seed)
    ref = jax_plan(f, len(tab.points), atoms.positions, atoms.charges, CUT)
    plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                              atoms.charges, CUT)
    assert plan.cpb == ref.cpb
    blk = np.repeat(np.arange(plan.nb), np.diff(plan.blk_ptr))
    assert (set(zip(blk.tolist(), plan.atile.tolist()))
            == set(zip(ref.blk.tolist(), ref.atile.tolist())))
    A = len(atoms.positions)
    np.testing.assert_array_equal(plan.atoms[:3, :A], ref.at[:3, :A])
    np.testing.assert_array_equal(plan.atoms[3, :A], ref.wt[0, :A])


def test_geometry_matches_jax_build_geom():
    import jax.numpy as jnp
    from coulomb_gmg_tpu.ops.tile_density import _build_geom
    f, atoms, tab = tile_setup(1, 3, 5)
    ref_plan = jax_plan(f, len(tab.points), atoms.positions, atoms.charges,
                        CUT)
    C, n_q = f.n_cells, len(tab.points)
    G = np.asarray(_build_geom(
        jnp.asarray(ref_plan.cells16), jnp.asarray(tab.points, jnp.float32),
        dim=3, n_q=n_q, cpb=ref_plan.cpb, p_tile=ref_plan.p_tile,
        h0=float(f.h0), lower0=tuple(float(x) for x in f.lower)))
    G = G.reshape(8, -1, ref_plan.p_tile)[:, :, : ref_plan.cpb * n_q]
    G = G.reshape(8, -1)[:, : C * n_q]
    plan = td.build_tile_plan(f, n_q, atoms.positions, atoms.charges, CUT)
    pts, anc = td.build_geom(torch.from_numpy(plan.cells),
                             torch.from_numpy(tab.points.astype(np.float32)),
                             float(f.h0), f.lower)
    np.testing.assert_array_equal(pts[:, : C * n_q].numpy(), G[:3])
    np.testing.assert_array_equal(
        np.repeat(anc[:, :C].numpy(), n_q, axis=1), G[3:6])


def test_cpu_dispatch_is_plain_and_cuda_path_never_falls_back():
    f, atoms, tab = tile_setup(1, 3)
    plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                              atoms.charges, CUT, n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, tab.points, plan, R_C, CUT, "cpu")
    before = td.tile_density.launches
    out = td.tile_density(*args, n_out=f.n_cells + 1, **kw)
    assert torch.equal(out, td.tile_density_plain(*args, n_out=f.n_cells + 1,
                                                  **kw))
    assert td.tile_density.launches == before
    with pytest.raises(ValueError):
        td.tile_density_cuda(*args, n_out=f.n_cells + 1, **kw)
