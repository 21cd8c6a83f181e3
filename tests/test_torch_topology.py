"""The adaptive cycle's mesh topology of the PyTorch port, torch code on the
forest's device (mesh/forest.py key helpers and ``level_cells``,
mesh/dofs.py, adapt/transfer.py, ops/stencil.py:level_topology,
solver/device_gmg.py:copy_maps, adapt/estimator.py), against the JAX
package's numpy modules on the seeded forests of tests/test_torch_host.py
(2D and 3D, refined twice with 2:1 balance, degree 1 and 2): every integer
array equal in dtype and order, the float64 transfer and Kelly estimate
within rel 1e-14 (max |diff| / max |ref|), marking flags identical.  Here
the forest's device is the CPU; tests/test_torch_cuda.py holds the card's
results to these."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coulomb_gmg_tpu.adapt import estimator as JE
from coulomb_gmg_tpu.adapt import transfer as JT
from coulomb_gmg_tpu.mesh import forest as JM
from coulomb_gmg_tpu.ops import stencil as JS
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.solver import device_gmg as JD
from coulomb_gmg_tpu_torch.adapt import estimator as TE
from coulomb_gmg_tpu_torch.adapt import transfer as TT
from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.mesh import forest as TM
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch import profile_topology
from coulomb_gmg_tpu_torch.ops import stencil as TS
from coulomb_gmg_tpu_torch.solver import device_gmg as TG
from coulomb_gmg_tpu_torch.topology import topology_outputs
from coulomb_gmg_tpu_torch.utils import native
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from test_torch_host import CASES, _forests
from torch_parity import jax_forest, rel_err

torch.set_num_threads(2)

FLOAT_RTOL = 1e-14
DEGREES = [1, 2]


def _same(t, j, what=""):
    """A port tensor equal to a JAX numpy array in dtype, shape and value."""
    assert isinstance(t, torch.Tensor), what
    t = t.numpy()
    assert t.dtype == np.asarray(j).dtype, (what, t.dtype, np.asarray(j).dtype)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _pair(dim, reps, seed):
    return _forests(TM, dim, reps, seed), _forests(JM, dim, reps, seed)


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_build_dofs_matches_jax(dim, reps, seed, degree):
    """keys, cell2dof, boundary, positions of every forest of the run."""
    for ft, fj in zip(*_pair(dim, reps, seed)):
        dt, dj = ft.dofs_of(degree), fj.dofs_of(degree)
        for name in ("keys", "cell2dof", "boundary", "positions"):
            _same(getattr(dt, name), getattr(dj, name), name)
        assert dt.n_dofs == dj.n_dofs and dt.degree == dj.degree == degree


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_hanging_pairs_match_jax(dim, reps, seed, degree):
    ft, fj = (f[-1] for f in _pair(dim, reps, seed))
    pt, pj = ft.dofs_of(degree).hanging_pairs, fj.dofs_of(degree).hanging_pairs
    assert len(pj[0]) > 0
    for name, t, j in zip(("rows", "cols", "weights"), pt, pj):
        _same(t, j, name)


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_level_dofs_match_jax(dim, reps, seed, degree):
    ft, fj = (f[-1] for f in _pair(dim, reps, seed))
    lt, lj = ft.dofs_of(degree).levels, fj.dofs_of(degree).levels
    assert len(lt) == len(lj) == 3
    for a, b in zip(lt, lj):
        for name in ("keys", "cell2dof", "active_index", "boundary",
                     "interface"):
            _same(getattr(a, name), getattr(b, name), f"{a.level} {name}")
        assert (a.level, a.n_dofs, a.degree) == (b.level, b.n_dofs, b.degree)


@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_level_cells_and_key_index_match_jax(dim, reps, seed):
    """``level_cells`` and the key helpers on tensors; KeyIndex lookups
    give the query's kind back."""
    ft, fj = (f[-1] for f in _pair(dim, reps, seed))
    for (ct, at), (cj, aj) in zip(ft.level_cells, fj.level_cells):
        _same(ct, cj, "level_ijk")
        _same(at, aj, "active_index")
    keys_t = ft.nkey(ft.ijk_t * 2, 2)
    _same(keys_t, fj.nkey(fj.ijk * 2, 2), "nkey")
    _same(ft.nkey_to_coords(keys_t, 2), fj.nkey_to_coords(
        fj.nkey(fj.ijk * 2, 2), 2), "nkey_to_coords")
    l = ft.max_level
    _same(ft.level_cell_key(l, ft.ijk_t), fj.level_cell_key(l, fj.ijk),
          "level_cell_key")
    ki, kj = TM.KeyIndex(keys_t), JM.KeyIndex(fj.nkey(fj.ijk * 2, 2))
    _same(ki.keys, kj.keys, "KeyIndex.keys")
    rng = np.random.default_rng(seed)
    query = np.concatenate([rng.choice(kj.keys, 50),
                            rng.integers(0, kj.keys.max() + 2, 50)])
    _same(ki.lookup(torch.from_numpy(query)), kj.lookup(query), "lookup")
    out = ki.lookup(query)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, kj.lookup(query))
    sel = np.flatnonzero(fj.level == l)
    kw, ow = TM.KeyIndex.with_order(ft.level_cell_key(l, ft.ijk_t[sel]))
    kwj, owj = JM.KeyIndex.with_order(fj.level_cell_key(l, fj.ijk[sel]))
    _same(kw.keys, kwj.keys, "with_order keys")
    _same(ow, owj, "with_order order")


@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_level_topology_and_copy_maps_match_jax(dim, reps, seed):
    """ops/stencil.py:level_topology (every field, dtypes included), its
    signature, and solver/device_gmg.py:copy_maps."""
    ft, fj = (f[-1] for f in _pair(dim, reps, seed))
    dt, dj = ft.dofs_of(1), fj.dofs_of(1)
    for l, (lt, lj) in enumerate(zip(dt.levels, dj.levels)):
        a, b = TS.level_topology(ft, lt, l), JS.level_topology(fj, lj, l)
        for name in ("coords", "mask8", "elim", "iface", "boundary"):
            _same(getattr(a, name), getattr(b, name), f"{l} {name}")
        assert (a.level, a.n, a.side, a.h) == (b.level, b.n, b.side, b.h)
        assert TS.topology_signature(a) == JS.topology_signature(b)
    for (gt, lt), (gj, lj) in zip(TG.copy_maps(ft, dt), JD.copy_maps(fj, dj)):
        _same(gt, gj, "global ids")
        _same(lt, lj, "level ids")


@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_face_plans_match_jax(dim, reps, seed):
    """The face plan built on each forest, and carried across the two
    refinements by update_face_plan, field for field."""
    fts, fjs = _pair(dim, reps, seed)
    names = ("sl_a", "sl_b", "sl_axis", "cf_fine", "cf_coarse", "cf_axis",
             "cf_side", "cf_sub")
    pt, pj = TE.build_face_plan(fts[0]), JE.build_face_plan(fjs[0])
    for k in range(1, len(fts)):
        pt = TE.update_face_plan(fts[k - 1], fts[k], pt,
                                 TT.old_cell_of_new(fts[k - 1], fts[k]))
        pj = JE.update_face_plan(fjs[k - 1], fjs[k], pj,
                                 JT.old_cell_of_new(fjs[k - 1], fjs[k]))
        bt, bj = TE.build_face_plan(fts[k]), JE.build_face_plan(fjs[k])
        for name in names:
            _same(getattr(pt, name), getattr(pj, name), f"updated {name}")
            _same(getattr(bt, name), getattr(bj, name), f"built {name}")
        assert len(pt.cf_fine) > 0


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_transfer_matches_jax(dim, reps, seed, degree):
    """old_cell_of_new exactly, transfer_solution within rel 1e-14 (float64,
    the eight octant embeddings), transfer_cell_mask exactly."""
    fts, fjs = _pair(dim, reps, seed)
    for k in range(1, len(fts)):
        old, new, jold, jnew = fts[k - 1], fts[k], fjs[k - 1], fjs[k]
        omap = TT.old_cell_of_new(old, new)
        _same(omap, JT.old_cell_of_new(jold, jnew), "old_cell_of_new")
        u = np.random.default_rng(seed + k).standard_normal(
            old.dofs_of(degree).n_dofs)
        got = TT.transfer_solution(old, new, u, degree=degree, omap=omap)
        ref = JT.transfer_solution(jold, jnew, u, degree=degree)
        assert got.dtype == torch.float64 and got.shape == ref.shape
        assert rel_err(got.numpy(), ref) <= FLOAT_RTOL
        if degree == 1:
            np.testing.assert_array_equal(got.numpy(), ref)
        rng = np.random.default_rng(seed)
        mask = rng.random((old.n_cells, 5)) < 0.3
        lists = rng.integers(-1, 40, (old.n_cells, 7)).astype(np.int32)
        for m in (mask, lists):
            out = TT.transfer_cell_mask(old, new, m, omap=omap)
            ref_m = JT.transfer_cell_mask(jold, jnew, m)
            assert out.dtype == ref_m.dtype
            np.testing.assert_array_equal(out, ref_m)
            _same(TT.transfer_cell_mask(old, new, torch.from_numpy(m),
                                        omap=omap), ref_m, "tensor mask")


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_estimate_matches_jax(dim, reps, seed, degree):
    """The Kelly estimate with and without the volume term within rel
    1e-14, and the marking flags and threshold of both."""
    ft, fj = (f[-1] for f in _pair(dim, reps, seed))
    tab = element_tables(dim, degree, degree + 1)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(ft.dofs_of(degree).n_dofs)
    rho = rng.standard_normal((ft.n_cells, len(tab.weights)))
    plan_t, plan_j = TE.build_face_plan(ft), JE.build_face_plan(fj)
    for vol in (False, True):
        got = TE.estimate(ft, ft.dofs_of(degree).cell2dof, u, rho,
                          tab.points, tab.weights, degree=degree,
                          use_volume_term=vol, plan=plan_t)
        ref = JE.estimate(fj, fj.dofs_of(degree).cell2dof, u, rho,
                          tab.points, tab.weights, degree=degree,
                          use_volume_term=vol, plan=plan_j)
        assert got.dtype == torch.float64 and got.shape == ref.shape
        assert rel_err(got.numpy(), ref) <= FLOAT_RTOL
        flags, thr = TE.mark_cells(got, 0.6)
        jflags, jthr = JE.mark_cells(ref, 0.6)
        _same(flags, jflags, "flags")
        assert abs(thr - jthr) <= FLOAT_RTOL * jthr


def test_estimate_and_marking_on_the_8_atom_trajectory(monkeypatch):
    """The port's production run at 8 atoms: on every cycle its Kelly
    estimate equals the JAX estimate of the same solution on the same mesh
    within rel 1e-14, and the flags that refine the mesh are identical."""
    seen = []
    orig = Simulation.estimate_and_mark

    def spy(self):
        orig(self)
        seen.append((self.forest, np.array(self.solution),
                     TM.to_host(self.error_per_cell).copy(),
                     np.array(self.flags), self.threshold))

    monkeypatch.setattr(Simulation, "estimate_and_mark", spy)
    cfg = production_scaling_config(1, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    res = sim.run()
    assert [r["n_cells"] for r in res] == [85184, 85744, 87648, 91344, 99464]
    assert len(seen) == 5
    tab = element_tables(3, 1, 2)
    for f, u, err, flags, thr in seen:
        jf = jax_forest(f)
        ref = JE.estimate(jf, jf.dofs_of(1).cell2dof, u, None, tab.points,
                          tab.weights, degree=1, use_volume_term=False,
                          plan=JE.build_face_plan(jf))
        assert rel_err(err, ref) <= FLOAT_RTOL
        jflags, jthr = JE.mark_cells(ref, cfg.refine_fraction_of_max)
        np.testing.assert_array_equal(flags, jflags)
        assert flags.any() and abs(thr - jthr) <= FLOAT_RTOL * jthr


def test_moved_functions_use_no_numpy_or_native_path(monkeypatch):
    """Every moved function returns tensors on the forest's device, with
    the native engine's sorts and lookups and numpy's sort, search, unique
    and bincount poisoned: none of them takes a host numpy path."""
    fts = _forests(TM, 3, 6, 1)
    old, new = fts[-2], fts[-1]
    flags = np.random.default_rng(0).random(new.n_cells) < 0.2
    newer = new.refine(flags)          # the forest itself stays host numpy

    def poisoned(name):
        def run(*a, **k):
            raise AssertionError(f"{name} called")
        return run

    for name in ("sort_unique_inverse", "lookup", "searchsorted",
                 "gather_rows"):
        monkeypatch.setattr(native, name, poisoned(f"native.{name}"))
    for name in ("unique", "searchsorted", "argsort", "lexsort", "bincount",
                 "sort", "nonzero", "flatnonzero"):
        monkeypatch.setattr(np, name, poisoned(f"np.{name}"))

    dev = new.device
    dofs = newer.dofs_of(1)
    tensors = [dofs.keys, dofs.cell2dof, dofs.boundary, dofs.positions,
               *dofs.hanging_pairs]
    for ld in dofs.levels:
        tensors += [ld.keys, ld.cell2dof, ld.active_index, ld.boundary,
                    ld.interface]
        t = TS.level_topology(newer, ld, ld.level)
        tensors += [t.coords, t.mask8, t.elim, t.iface, t.boundary]
    for g, l in TG.copy_maps(newer, dofs):
        tensors += [g, l]
    omap = TT.old_cell_of_new(new, newer)
    u = TT.transfer_solution(new, newer, torch.ones(new.dofs_of(1).n_dofs),
                             omap=omap)
    plan = TE.update_face_plan(new, newer, TE.build_face_plan(new), omap)
    tab = element_tables(3, 1, 2)
    err = TE.estimate(newer, dofs.cell2dof, u, None, tab.points, tab.weights,
                      use_volume_term=False, plan=plan)
    marks, _ = TE.mark_cells(err)
    tensors += [omap, u, err, marks, *vars(plan).values()]
    tensors += [a for lc in newer.level_cells for a in lc]
    for t in tensors:
        assert isinstance(t, torch.Tensor) and t.device == dev


def test_a_forest_on_a_missing_card_raises():
    """A forest whose topology lives on the card builds it there or raises:
    without a card nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (tests/test_torch_cuda.py)")
    f = TM.Forest.uniform(3, 4, np.zeros(3), 0.25, device="cuda")
    assert f.device.type == "cuda"
    assert f.refine(np.ones(f.n_cells, bool)).device == f.device
    assert f.on("cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        f.dofs_of(1)


def test_profile_topology_on_the_cpu():
    """The per-function profile of the cycle's topology at 8 atoms: the
    moved functions are timed inside the driver's stages, and the run's
    cells are the published ones."""
    rec = profile_topology.main(["--n", "1", "--cycles", "2", "--device",
                                 "cpu"])
    assert [c["n_cells"] for c in rec["cycles"]] == [85184, 85744]
    refine = next(v for k, v in rec["cycles"][1]["stages"].items()
                  if k.startswith("Refine"))
    for name in ("Forest.refine", "old_cell_of_new", "transfer_solution",
                 "build_dofs", "_find_hanging", "_build_level",
                 "update_face_plan"):
        assert refine["functions"][name]["calls"] >= 1, name
    est = rec["cycles"][1]["stages"]["Estimate error and mark cells"]
    assert set(est["functions"]) >= {"estimate", "mark_cells"}
    amg = rec["cycles"][1]["stages"]["Assemble Multigrid"]
    assert set(amg["functions"]) >= {"level_topology", "topology_signature",
                                     "copy_maps"}
    assert rec["host"]["cpu_count"] >= 1 and rec["dtype"] == "float32"


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_gather_form_bincount_is_numpys(n):
    """The estimator's atomic-free ``np.bincount``: each bin sums its
    weights in the order they come, so repeated bins give numpy's bits."""
    rng = np.random.default_rng(n)
    idx, w = rng.integers(0, 50, n), rng.standard_normal(n)
    got = TE._bincount(torch.from_numpy(idx), torch.from_numpy(w), 60)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(idx, weights=w, minlength=60))


_ATEN = torch.ops.aten
_WAITS = {_ATEN.nonzero.default, _ATEN._local_scalar_dense.default,
          _ATEN.masked_select.default, _ATEN._unique2.default,
          _ATEN.unique_consecutive.default, _ATEN.unique_dim.default,
          _ATEN.repeat_interleave.Tensor, _ATEN.bincount.default}
_INDEX = {_ATEN.index.Tensor, _ATEN.index_put_.default,
          _ATEN.index_put.default}


class _HostWaits(TorchDispatchMode):
    """Counts the operations that make the host wait when their tensors
    lie on a card: a result of data-dependent size (nonzero, boolean
    indexing, unique, ...) or a value read back (item, bool, int)."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in _WAITS or (func in _INDEX and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dim, small, large", [(2, 12, 24), (3, 6, 10)])
def test_host_waits_do_not_grow_with_the_mesh(dim, small, large):
    """One refinement step's topology (``topology_outputs``: two DoF
    numberings, level topology, copy maps, transfer, face plans, estimate,
    marking) waits on the device as often on a mesh of 3-5x the cells as on
    the small one: its selections are per level, axis, face group and
    octant, never per cell; at most 60 a level."""
    counts = []
    for reps in (small, large):
        old, new = _forests(TM, dim, reps, 1)[-2:]
        rng = np.random.default_rng(0)
        u_old = rng.standard_normal(old.dofs_of(1).n_dofs)
        u_new = rng.standard_normal(new.dofs_of(1).n_dofs)
        old, new = _forests(TM, dim, reps, 1)[-2:]     # nothing cached
        with _HostWaits() as w:
            topology_outputs(old, new, u_old, u_new)
        counts.append((new.n_cells, new.n_levels, w.n))
    (c0, l0, n0), (c1, l1, n1) = counts
    assert c1 >= 3 * c0 and l0 == l1
    assert n0 == n1 and n0 <= 60 * l0, counts
