"""The SPMD path of the PyTorch port on the CPU: D shards, each on
``"cpu"``, against the single-device port and, run live on the same
inputs, the JAX package on the 8 virtual CPU devices of tests/conftest.py.

* the sharded tile density is bit-identical to the single-device one
  (tests/test_spmd_tiles.py) and agrees with JAX's sharded tile density
  to the tile kernel's float32 tolerance (nonzero pattern equal, atol
  2e-6 max, rtol 2e-5); the sharded Kelly estimate equals the host one
  and JAX's sharded one to rel 1e-12; the sharded mask/list density, FE
  error and assembly agree with their single-device versions;
* ``ShardedGMG`` and the sharded Jacobi-CG on the ``small_sim`` of
  tests/test_sharded_gmg.py: solutions within rel 1e-8 of one shard, the
  same CG count for every D, the halo import equal to the all-gather;
  ``ShardedGMG`` against JAX's ``ShardedGMG`` on JAX's ``small_sim`` and
  its right-hand side, D = 3 and 8: CG count equal, solution and final
  residual rel 1e-12 (3e-16 measured);
* the 8-atom float64 production trajectory for 2 cycles at D = 8 and D = 3
  (tests/test_spmd_production.py) against the JAX driver at D = 8
  (``production_scaling_config(1, dtype="float64", n_devices=8,
  n_adaptive_cycles=2)``, ~25 s): cells exact, CG counts equal, ``l2_rhs``
  rel 1e-10, ``l2_sol`` rel 1e-8;
* one VTU piece per shard with its ``subdomain`` (tests/
  test_spmd_pipeline.py:102).
"""

import os
import re

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import build_face_plan, estimate
from coulomb_gmg_tpu_torch.config import (golden_gaussian_config,
                                          production_scaling_config)
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.fem import assembly
from coulomb_gmg_tpu_torch.fem.assembly import (assemble_np, build_plan,
                                                gather_sum)
from coulomb_gmg_tpu_torch.fem.integrals import (rhs_cells_np,
                                                 stiffness_cells_np)
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice, two_atom_pair
from coulomb_gmg_tpu_torch.ops.density import atom_masks, compute_density
from coulomb_gmg_tpu_torch.ops.neighbors import atom_lists
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.tile_density import density_locality_tiles
from coulomb_gmg_tpu_torch.parallel.sharded import (
    HaloPlan, ShardedCSR, halo_import, make_sharded_solver, put_blocks,
    shard_vector, sharded_diag)
from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
from coulomb_gmg_tpu_torch.postprocess.energy import energy_norm_error
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import CUT, R_C, refined_problem, tile_setup

torch.set_num_threads(2)

REF_CELLS_8 = [85184, 85744, 87648, 91344, 99464]
SMALL = dict(n_adaptive_cycles=2, flag_output_time=False, mesh_size_h=0.5,
             vacuum_repetitions=4)


def ctx(D):
    return SpmdContext(D, ["cpu"] * D)


def jax_mesh(D):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:D]), ("shard",))


# ---------------------------------------------------------------------------
# the sharded stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D, refine_seed", [(2, None), (3, None), (8, None),
                                            (8, 0)])
def test_density_tiles_bit_identical(D, refine_seed):
    f, atoms, tab = tile_setup(1, 3, refine_seed)
    ref = density_locality_tiles(f, tab.points, atoms.positions,
                                 atoms.charges, R_C, CUT, "cpu",
                                 c_pad=f.n_cells)
    got = ctx(D).density_tiles(f, tab.points, atoms.positions,
                               atoms.charges, R_C, CUT)
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("D, refine_seed", [(2, None), (3, None), (8, None),
                                            (8, 0)])
def test_density_tiles_matches_jax(D, refine_seed):
    """The port's sharded tile density against JAX's sharded Pallas one
    (interpret mode) on the same mesh and atoms."""
    from coulomb_gmg_tpu.parallel.spmd import SpmdContext as JaxSpmd
    f, atoms, tab = tile_setup(1, 3, refine_seed)
    ref = np.asarray(JaxSpmd(D).density_tiles(
        f, tab.points, atoms.positions, atoms.charges, R_C, CUT,
        interpret=True))
    got = ctx(D).density_tiles(f, tab.points, atoms.positions,
                               atoms.charges, R_C, CUT).numpy()
    C = f.n_cells
    assert got.shape[1] == ref.shape[1] and len(got) >= C
    np.testing.assert_array_equal(got[:C] != 0, ref[:C] != 0)
    np.testing.assert_allclose(got[:C], ref[:C], rtol=2e-5,
                               atol=2e-6 * np.abs(ref[:C]).max())


@pytest.mark.parametrize("D", [3, 8])
def test_estimator_matches_host(D):
    """Sharded Kelly estimator == host float64 estimator, coarse-fine
    subfaces included (tests/test_spmd_tiles.py:57)."""
    f, _, tab = tile_setup(1, 3)
    rng = np.random.default_rng(3)
    f2 = f.refine(rng.random(f.n_cells) < 0.01)
    dofs = f2.dofs_of(1)
    u = rng.standard_normal(dofs.n_dofs)
    plan = build_face_plan(f2)
    ref = estimate(f2, dofs.cell2dof, u, None, tab.points, tab.weights,
                   degree=1, use_volume_term=False, plan=plan)
    got = ctx(D).estimate(f2, dofs.cell2dof, u, plan=plan)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("D", [3, 8])
def test_estimator_matches_jax(D):
    """The port's sharded Kelly estimate against JAX's sharded one, the
    same refined mesh and solution (tests/test_spmd_tiles.py:57)."""
    from coulomb_gmg_tpu.adapt.estimator import build_face_plan as jplan
    from coulomb_gmg_tpu.parallel.spmd import SpmdContext as JaxSpmd
    f, _, _ = tile_setup(1, 3)
    rng = np.random.default_rng(5)
    f2 = f.refine(rng.random(f.n_cells) < 0.02)
    dofs = f2.dofs_of(1)
    u = rng.standard_normal(dofs.n_dofs)
    ref = np.asarray(JaxSpmd(D).estimate(f2, dofs.cell2dof, u,
                                         plan=jplan(f2)))
    got = ctx(D).estimate(f2, dofs.cell2dof, u, plan=build_face_plan(f2))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("variant", ["mask", "lists", "all"])
def test_density_matches_single_device(variant):
    f, atoms, tab = tile_setup(1, 3, 2)
    kw = {}
    if variant == "mask":
        kw["mask"] = atom_masks(f, atoms.positions, CUT, "cpu")
    elif variant == "lists":
        kw["lists"] = atom_lists(f, atoms.positions, CUT)[0]
    args = (f, tab.points, atoms.positions, atoms.charges, R_C)
    ref = compute_density(*args, "cpu", **kw)
    got = ctx(3).density(*args, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
def test_energy_norm_error_matches_single_device(dtype, tol):
    f, atoms, _ = tile_setup(1, 3, 1)
    tab = element_tables(3, 1, 2)
    u = np.random.default_rng(4).standard_normal(f.dofs_of(1).n_dofs) * 0.01
    args = (f, tab, u, atoms.positions, atoms.charges, R_C)
    ref = energy_norm_error(*args, "cpu", dtype=dtype)
    got = ctx(3).energy_norm_error(*args, dtype=dtype)
    assert got == pytest.approx(ref, rel=tol)


@pytest.mark.parametrize("width", [2, 8])
def test_gather_sum_equals_index_add(width, monkeypatch):
    """The rounds of gather_sum (targets hit 1 to 200 times) give the sums
    of index_add, and the same bits on a second call."""
    monkeypatch.setattr(assembly, "GATHER_WIDTH", width)
    rng = np.random.default_rng(width)
    pos = np.repeat(rng.permutation(500)[:300], rng.integers(1, 200, 300))
    pos = rng.permutation(pos)
    vals = torch.from_numpy(rng.standard_normal(len(pos)))
    ref = torch.zeros(500, dtype=torch.float64).index_add_(
        0, torch.from_numpy(pos), vals)
    got = gather_sum(vals, pos, 500)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    assert torch.equal(got, gather_sum(vals, pos, 500))


@pytest.mark.parametrize("np_dtype, tol", [(np.float64, 1e-12),
                                           (np.float32, 1e-5)])
def test_assembler_matches_host_assembly(np_dtype, tol):
    """Per-shard element tensors gathered into the CSR slots and summed
    over the shards (hanging nodes, inhomogeneous constraints)."""
    f, dofs, con, rho, tab = refined_problem(1)
    tab_lap = element_tables(3, 1, 2)
    plan = build_plan(dofs.cell2dof, con)
    h = f.cell_h()
    coeff = 1.0 + np.random.default_rng(5).random((f.n_cells,
                                                   len(tab_lap.points)))
    for coeff_q in (None, coeff):
        K = stiffness_cells_np(tab_lap, h, coeff_q, dtype=np_dtype)
        F = rhs_cells_np(tab, h, rho, dtype=np_dtype)
        data, rhs = assemble_np(plan, K, F, dtype=np_dtype)
        asm = ctx(3).build_assembler(plan, tab_lap, tab,
                                     has_coeff=coeff_q is not None,
                                     np_dtype=np_dtype)
        got_d, got_r = asm(h, coeff_q, rho)
        np.testing.assert_allclose(got_d, data, rtol=tol,
                                   atol=tol * np.abs(data).max())
        np.testing.assert_allclose(got_r, rhs, rtol=tol,
                                   atol=tol * np.abs(rhs).max())


# ---------------------------------------------------------------------------
# the sharded solvers (tests/test_sharded_gmg.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_sim():
    sim = Simulation(golden_gaussian_config(**SMALL), atoms=two_atom_pair(),
                     device="cpu", pcout=Pcout(enabled=False))
    sim.run()
    return sim


@pytest.fixture(scope="module")
def jax_small_sim():
    """The ``small_sim`` of tests/test_sharded_gmg.py, run by JAX."""
    from coulomb_gmg_tpu.config import golden_gaussian_config as jcfg
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.models.atoms import two_atom_pair as jpair
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    sim = JaxSimulation(jcfg(**SMALL), atoms=jpair(),
                        pcout=JaxPcout(enabled=False))
    sim.run()
    return sim


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_sharded_gmg_is_device_count_invariant(small_sim):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    bnorm = np.linalg.norm(rhs)
    out = {}
    for D in (1, 3, 8):
        sg = ShardedGMG(sim.gmg, sim.A, ctx(D), dtype=sim.dtype, maxiter=50)
        x, k, res0, res = sg.solve(rhs, rtol=1e-8)
        assert res0 == pytest.approx(bnorm, rel=1e-12)
        assert res <= 1e-8 * bnorm and 1 <= k <= 20
        out[D] = (x, k)
    assert len({k for _, k in out.values()}) == 1, out
    for D in (3, 8):
        assert _rel(out[D][0], out[1][0]) < 1e-8
    # the single-device (SSOR) solve of the driver, to the solve tolerance
    from coulomb_gmg_tpu_torch.fem.constraints import distribute
    assert _rel(distribute(sim.constraints, out[8][0]), sim.solution) < 1e-5


@pytest.mark.parametrize("D", [3, 8])
def test_sharded_gmg_matches_jax(small_sim, jax_small_sim, D):
    """The port's ShardedGMG on its own operator and JAX's ShardedGMG on
    JAX's, both given JAX's right-hand side: the same CG count and the
    same solution (the coarse solve once per device against JAX's on
    every shard, ELL gathers against COO scatter-adds)."""
    from coulomb_gmg_tpu.parallel.sharded_gmg import ShardedGMG as JaxGMG
    js = jax_small_sim
    assert small_sim.forest.n_cells == js.forest.n_cells
    rhs = np.asarray(js.rhs)
    assert _rel(np.asarray(small_sim.rhs), rhs) < 1e-12
    xj, kj, res0j, resj = JaxGMG(js.gmg, js.A, jax_mesh(D), dtype=js.dtype,
                                 maxiter=50).solve(rhs, rtol=1e-8)
    x, k, res0, res = ShardedGMG(small_sim.gmg, small_sim.A, ctx(D),
                                 dtype=small_sim.dtype,
                                 maxiter=50).solve(rhs, rtol=1e-8)
    assert k == kj
    assert res0 == pytest.approx(res0j, rel=1e-12)
    assert res == pytest.approx(resj, rel=1e-12)
    assert _rel(x, np.asarray(xj)) < 1e-12


def test_sharded_jacobi_cg_is_device_count_invariant(small_sim):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    out = {}
    for D in (1, 3, 8):
        c = ctx(D)
        A = ShardedCSR.from_coo(sim.A.rowids, sim.A.indices,
                                sim.A.data_np(), sim.A.n_rows, D)
        solver = make_sharded_solver(c, A, sharded_diag(A, D),
                                     tol_rtol=1e-8, maxiter=2000)
        b = put_blocks(shard_vector(rhs, D), c)
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        assert res < 1e-8 * np.linalg.norm(rhs)
        out[D] = (torch.cat(xb).numpy()[: len(rhs)], k)
    assert len({k for _, k in out.values()}) == 1, out
    for D in (3, 8):
        assert _rel(out[D][0], out[1][0]) < 1e-8


def test_halo_import_matches_all_gather(small_sim):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    c = ctx(8)
    outs = {}
    for halo in (True, False):
        sg = ShardedGMG(sim.gmg, sim.A, c, dtype=sim.dtype, maxiter=50,
                        halo=halo)
        outs[halo] = sg.solve(rhs, rtol=1e-8)
    assert outs[True][1] == outs[False][1]
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    # the imported ghosts are the owners' values
    A = ShardedCSR.from_coo(sim.A.rowids, sim.A.indices, sim.A.data_np(),
                            sim.A.n_rows, 8)
    plan = HaloPlan.build(A.cols, A.block, 8)
    x = np.random.default_rng(0).standard_normal(A.n_rows)
    ext = halo_import(put_blocks(x.reshape(8, -1), c), plan, c)
    for d in range(8):
        np.testing.assert_array_equal(ext[d].numpy()[plan.cols_local[d]],
                                      x[A.cols[d]])


# ---------------------------------------------------------------------------
# the driver (tests/test_spmd_production.py, tests/test_spmd_pipeline.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_d8():
    """The JAX driver's 8-atom float64 trajectory on 8 devices."""
    from coulomb_gmg_tpu.config import production_scaling_config as jcfg
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.models.atoms import nacl_lattice as jlattice
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    cfg = jcfg(1, dtype="float64", n_devices=8, n_adaptive_cycles=2)
    return JaxSimulation(cfg, atoms=jlattice(1),
                         pcout=JaxPcout(enabled=False)).run()


@pytest.mark.parametrize("D", [8, 3])
def test_8_atom_trajectory_matches_jax(jax_d8, D):
    cfg = production_scaling_config(1, dtype="float64", n_devices=D,
                                    n_adaptive_cycles=2)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False), spmd_devices=["cpu"] * D)
    res = sim.run()
    assert not sim.device_ops and not sim.use_tpu_cg
    assert [r["n_cells"] for r in res] == REF_CELLS_8[:2]
    assert [r["n_cells"] for r in jax_d8] == REF_CELLS_8[:2]
    assert ([r["cg_iterations"] for r in res]
            == [r["cg_iterations"] for r in jax_d8])
    for r, j in zip(res, jax_d8):
        assert r["l2_rhs"] == pytest.approx(j["l2_rhs"], rel=1e-10)
        assert r["l2_sol"] == pytest.approx(j["l2_sol"], rel=1e-8)
        assert r["residual"] <= 1.01e-8 * r["l2_rhs"]


def test_sharded_vtu_pieces_and_subdomains(tmp_path):
    cfg = golden_gaussian_config(n_adaptive_cycles=1, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4,
                                 n_devices=8, write_vtu=True,
                                 output_dir=str(tmp_path))
    sim = Simulation(cfg, atoms=two_atom_pair(), device="cpu",
                     pcout=Pcout(enabled=False), spmd_devices=["cpu"] * 8)
    res = sim.run()
    pieces = sorted(p for p in os.listdir(tmp_path)
                    if re.fullmatch(r"solution-00000\.\d{4}\.vtu", p))
    assert len(pieces) == 8
    txt = open(tmp_path / "solution-00000.pvtu").read()
    assert all(p in txt for p in pieces) and 'Name="subdomain"' in txt
    from test_torch_vtu import read_vtu
    n_total = 0
    for d, p in enumerate(pieces):
        attrs, arrays = read_vtu(str(tmp_path / p))
        n_total += int(attrs["NumberOfCells"])
        assert (arrays["subdomain"] == d).all()
        assert np.isfinite(arrays["solution"]).all()
    assert n_total == res[0]["n_cells"]
