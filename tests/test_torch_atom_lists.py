"""The compact atom lists of the PyTorch port (ops/neighbors.py:
``AtomLists``, ``locality_lists``): the padded layout round-trips, the
mask form equals ``masks_to_lists``, refinement carries ``home`` to the
rows that the padded lists' row gather gives, ``compute_density`` over them
has the padded call's bits on the CPU, and checkpoints keep them (and
still load padded ones and masks), beside the form the JAX driver reads."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.adapt.transfer import (
    coarsen_cell_mask, old_cell_of_new, transfer_cell_mask)
from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.mesh.forest import to_host
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops import density as TD
from coulomb_gmg_tpu_torch.ops.neighbors import (AtomLists, atom_lists,
                                                 locality_lists)
from coulomb_gmg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import CUT, R_C, tile_setup

torch.set_num_threads(2)


def _refined_twice(refine_seed=5):
    """The cycle-0 mesh with its lists, and two refinements of it."""
    f0, atoms, tab = tile_setup(1, 2)
    rng = np.random.default_rng(refine_seed)
    f1 = f0.refine(rng.random(f0.n_cells) < 0.1)
    f2 = f1.refine(rng.random(f1.n_cells) < 0.1)
    return (f0, f1, f2), atoms, tab


@pytest.mark.parametrize("refine_seed", [None, 3])
def test_padded_lists_round_trip(refine_seed):
    f, atoms, _ = tile_setup(1, 2, refine_seed)
    lists = locality_lists(f, atoms.positions, CUT)
    padded, counts = atom_lists(f, atoms.positions, CUT)
    assert lists.ptr.dtype == np.int64 and lists.atoms.dtype == np.int32
    assert len(lists.ptr) == f.n_cells + 1 and lists.n_cells == f.n_cells
    assert 0 < (counts == 0).sum() < f.n_cells
    np.testing.assert_array_equal(lists.padded(), padded)
    np.testing.assert_array_equal(lists.counts, counts)
    back = AtomLists.from_padded(padded)
    np.testing.assert_array_equal(back.padded(), padded)
    for name in ("ptr", "atoms", "home"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(lists, name))


def test_from_mask_equals_masks_to_lists():
    f, atoms, _ = tile_setup(1, 2, 3)
    mask = TD.atom_masks(f, atoms.positions, CUT, "cpu")
    lists = AtomLists.from_mask(mask)
    want, counts = TD.masks_to_lists(mask)
    np.testing.assert_array_equal(lists.padded(), want)
    np.testing.assert_array_equal(lists.counts, counts)
    np.testing.assert_array_equal(
        lists.padded(), atom_lists(f, atoms.positions, CUT)[0])
    np.testing.assert_array_equal(lists.mask(mask.shape[1]), mask)


def test_home_carried_over_two_refinements():
    forests, atoms, _ = _refined_twice()
    lists = locality_lists(forests[0], atoms.positions, CUT)
    padded = lists.padded()
    rows0 = len(lists.ptr)
    for old, new in zip(forests, forests[1:]):
        omap = old_cell_of_new(old, new)
        lists = lists.carried(to_host(omap))
        padded = transfer_cell_mask(old, new, padded, omap=omap)
        assert lists.n_cells == new.n_cells and len(lists.ptr) == rows0
        np.testing.assert_array_equal(
            lists.padded(pad_to=padded.shape[1]), padded)
    assert lists.home.dtype == np.int32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh", ["uniform", "refined"])
def test_compute_density_of_atom_lists_equals_padded(dtype, mesh):
    forests, atoms, tab = _refined_twice()
    lists = locality_lists(forests[0], atoms.positions, CUT)
    f = forests[0]
    if mesh == "refined":
        for old, new in zip(forests, forests[1:]):
            lists = lists.carried(to_host(old_cell_of_new(old, new)))
        f = forests[-1]
    args = (f, tab.points, atoms.positions, atoms.charges, R_C, "cpu")
    kw = dict(dtype=dtype, pairs_per_chunk=1 << 14)
    got = TD.compute_density(*args, lists=lists, **kw)
    want = TD.compute_density(*args, lists=lists.padded(), **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (got != 0).any() and (got[torch.from_numpy(lists.counts == 0)]
                                 == 0).all()
    # a shard's block of cells and the padding rows after it
    cells = range(f.n_cells // 3, 2 * f.n_cells // 3)
    part = TD.compute_density(*args, lists=lists, cells=cells,
                              n_out=len(cells) + 2, **kw)
    assert torch.equal(part[:len(cells)], want[cells.start:cells.stop])
    assert not part[len(cells):].any()


def test_coarsen_takes_atom_lists_at_its_door():
    (f0, f1, _), atoms, _ = _refined_twice()
    lists = locality_lists(f0, atoms.positions, CUT).carried(
        to_host(old_cell_of_new(f0, f1)))
    flags = np.zeros(f1.n_cells, bool)
    flags[f1.level > 0] = True
    f2 = f1.coarsen(flags)
    np.testing.assert_array_equal(coarsen_cell_mask(f1, f2, lists),
                                  coarsen_cell_mask(f1, f2, lists.padded()))


def _config(**kw):
    # 216 atoms (compact lists above 64) in one layer of vacuum cells
    return production_scaling_config(3, dtype="float64", vacuum_repetitions=1,
                                     n_adaptive_cycles=2, **kw)


def _run(cfg):
    sim = Simulation(cfg, atoms=nacl_lattice(3), device="cpu",
                     pcout=Pcout(enabled=False))
    return sim, sim.run()


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    sim, res = _run(_config(checkpoint_dir=str(ckpt)))
    assert isinstance(sim.lists, AtomLists) and not hasattr(sim, "mask")
    return sim, res, ckpt / "ckpt_cycle000.npz"


@pytest.mark.parametrize("form", ["compact", "padded"])
def test_a_checkpoint_of_atom_lists_resumes(straight, tmp_path, form):
    sim, res, ckpt = straight
    with np.load(ckpt) as z:
        payload = dict(z)
    assert {"lists_ptr", "lists_atoms", "lists_home", "lists"} <= set(payload)
    assert "mask" not in payload
    if form == "padded":          # the JAX driver's and older snapshots
        for k in ("ptr", "atoms", "home"):
            payload.pop(f"lists_{k}")
        ckpt = tmp_path / "old.npz"
        np.savez_compressed(ckpt, **payload)
    *_, loaded, done = load_checkpoint(str(ckpt))
    assert done == 0 and isinstance(loaded, AtomLists)
    again, res2 = _run(_config(resume_from=str(ckpt)))
    assert [r["cycle"] for r in res2] == [1]
    assert res2[0]["n_cells"] == res[1]["n_cells"]
    assert res2[0]["cg_passes"] == res[1]["cg_passes"]
    np.testing.assert_array_equal(again.solution, sim.solution)
    np.testing.assert_array_equal(again.lists.padded(), sim.lists.padded())


def test_save_checkpoint_writes_the_compact_lists(straight, tmp_path):
    sim = straight[0]
    path = save_checkpoint(str(tmp_path / "c.npz"), sim, 1)
    lists = load_checkpoint(path)[3]
    for f in dataclasses.fields(AtomLists):
        np.testing.assert_array_equal(getattr(lists, f.name),
                                      getattr(sim.lists, f.name))


@pytest.mark.parametrize("reps", [1, 3])
def test_the_jax_loader_reads_a_port_snapshot(tmp_path, reps):
    """A port snapshot holds the JAX driver's locality beside the compact
    lists: the mask of 8 atoms, the padded lists of 216 (the cycle-0
    ancestors' rows, which the JAX resume takes as they are); the port
    loads either back to the same lists, also without the compact ones."""
    from coulomb_gmg_tpu.utils.checkpoint import load_checkpoint as jax_load
    forests, _, _ = _refined_twice()
    f0, f1 = forests[:2]
    _, atoms, _ = tile_setup(reps, 2)
    lists = locality_lists(f0, atoms.positions, CUT).carried(
        to_host(old_cell_of_new(f0, f1)))
    sim = types.SimpleNamespace(
        forest=f1, solution=np.zeros(3), flags=np.zeros(f1.n_cells, bool),
        lists=lists, atoms=atoms)
    path = save_checkpoint(str(tmp_path / "c.npz"), sim, 1)
    forest, _, _, mask, padded, done = jax_load(path)
    assert done == 1 and forest.n_cells == f1.n_cells
    if atoms.n > 64:
        assert mask is None
        np.testing.assert_array_equal(padded, lists.padded())
    else:
        assert padded is None
        np.testing.assert_array_equal(mask, lists.mask(atoms.n))
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if not k.startswith("lists_")}
    old = str(tmp_path / "jax_form.npz")
    np.savez_compressed(old, **payload)
    for p in (path, old):
        back = load_checkpoint(p)[3]
        np.testing.assert_array_equal(back.padded(), lists.padded())
