"""The port's own copies of the JAX package's host modules (mesh/, fem/,
adapt/transfer.py, ops/neighbors.py, config.py, models/atoms.py,
io/vtu.py, io/gnuplot.py, and the native engine they run, built from the
port's csrc/forest_engine.cpp)
against the JAX package's modules on the same seeded numpy inputs: every
array equal, nothing within a tolerance."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu import config as JC
from coulomb_gmg_tpu.adapt import transfer as JT
from coulomb_gmg_tpu.fem import constraints as JF
from coulomb_gmg_tpu.io import gnuplot as JG
from coulomb_gmg_tpu.io import vtu as JV
from coulomb_gmg_tpu.mesh import forest as JM
from coulomb_gmg_tpu.models import atoms as JA
from coulomb_gmg_tpu.ops import neighbors as JN
from coulomb_gmg_tpu_torch import config as TC
from coulomb_gmg_tpu_torch.adapt import transfer as TT
from coulomb_gmg_tpu_torch.fem import constraints as TF
from coulomb_gmg_tpu_torch.io import gnuplot as TG
from coulomb_gmg_tpu_torch.io import vtu as TV
from coulomb_gmg_tpu_torch.mesh import forest as TM
from coulomb_gmg_tpu_torch.models import atoms as TA
from coulomb_gmg_tpu_torch.ops import neighbors as TN
from coulomb_gmg_tpu_torch.utils import native
from torch_parity import CUT, ROOT, dipole_bc

torch.set_num_threads(2)

CASES = [(2, 12, 0), (3, 6, 1)]        # (dim, base cells per axis, seed)


def _forests(pkg, dim, reps, seed):
    """A base forest and the one after two refinements with seeded marks."""
    f = pkg.Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
    rng = np.random.default_rng(seed)
    out = [f]
    for _ in range(2):
        f = f.refine(rng.random(f.n_cells) < 0.2)
        out.append(f)
    return out


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_engine_builds_from_the_port_sources():
    assert native.available()
    so = native.library_path()
    assert os.path.dirname(os.path.dirname(so)) == os.path.join(
        ROOT, "build", "native")
    assert os.path.basename(so) == "libforest_engine.so"
    assert os.path.isfile(so)


@pytest.mark.parametrize("no_native, warned", [("", True), ("1", False)])
def test_native_engine_failure_is_reported(monkeypatch, capsys, tmp_path,
                                           no_native, warned):
    """A failed build takes the numpy path with one warning on stderr;
    CGMG_NO_NATIVE takes it silently."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setenv("CGMG_NO_NATIVE", no_native)
    assert not native.available()
    err = capsys.readouterr().err
    assert ("[native] forest engine unavailable" in err) == warned
    assert err.count("\n") == int(warned)


@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_forest_matches_jax(dim, reps, seed):
    for t, j in zip(_forests(TM, dim, reps, seed),
                    _forests(JM, dim, reps, seed)):
        _eq(t.level, j.level)
        _eq(t.ijk, j.ijk)
        keys_t, keys_j = t.cell_corner_keys(), j.cell_corner_keys()
        _eq(keys_t, keys_j)
        kt, kj = TM.KeyIndex(keys_t), JM.KeyIndex(keys_j)
        _eq(kt.keys, kj.keys)
        rng = np.random.default_rng(seed)
        query = np.concatenate([rng.choice(kt.keys, 50),
                                rng.integers(0, kt.keys.max() + 2, 50)])
        _eq(kt.lookup(query), kj.lookup(query))


@pytest.mark.parametrize("dim, reps, seed", CASES)
def test_dofs_constraints_transfer_match_jax(dim, reps, seed):
    ft = _forests(TM, dim, reps, seed)
    fj = _forests(JM, dim, reps, seed)
    dt, dj = ft[-1].dofs_of(1), fj[-1].dofs_of(1)
    for name in ("keys", "cell2dof", "boundary", "positions"):
        _eq(getattr(dt, name), getattr(dj, name))
    assert len(dt.levels) == len(dj.levels)
    for lt, lj in zip(dt.levels, dj.levels):
        for name in ("keys", "cell2dof", "active_index", "boundary",
                     "interface"):
            _eq(getattr(lt, name), getattr(lj, name))
    bc = dipole_bc if dim == 3 else None
    ct, cj = TF.build_constraints(dt, bc), JF.build_constraints(dj, bc)
    for name in ("rows", "indptr", "cols", "weights", "inhomog"):
        _eq(getattr(ct, name), getattr(cj, name))
    u = np.random.default_rng(seed).standard_normal(
        ft[-2].dofs_of(1).n_dofs)
    _eq(TT.old_cell_of_new(ft[-2], ft[-1]),
        JT.old_cell_of_new(fj[-2], fj[-1]))
    _eq(TT.transfer_solution(ft[-2], ft[-1], u, degree=1),
        JT.transfer_solution(fj[-2], fj[-1], u, degree=1))
    _eq(TF.distribute(ct, dt.positions[:, 0]),
        JF.distribute(cj, dj.positions[:, 0]))


@pytest.mark.parametrize("n, refine_seed", [(1, None), (2, None), (1, 3)])
def test_atom_lists_and_buckets_match_jax(n, refine_seed):
    pos = TA.nacl_lattice(n).positions
    pos = np.vstack([pos, np.random.default_rng(n).uniform(
        pos.min(), pos.max(), (17, 3))])
    for pitch in (CUT, 0.6):
        origin = pos.min(axis=0)
        for a, b in zip(TN.build_atom_buckets(pos, pitch, origin),
                        JN.build_atom_buckets(pos, pitch, origin)):
            _eq(a, b)
    vac = 3
    reps = int(round(2 * (n / 0.5 + 2 * vac)))
    ft = TM.Forest.uniform(3, reps, np.full(3, -vac * 0.5), 0.25)
    fj = JM.Forest.uniform(3, reps, np.full(3, -vac * 0.5), 0.25)
    if refine_seed is not None:
        flags = np.random.default_rng(refine_seed).random(ft.n_cells) < 0.1
        ft, fj = ft.refine(flags), fj.refine(flags)
    (lt, ct), (lj, cj) = TN.atom_lists(ft, pos, CUT), JN.atom_lists(fj, pos,
                                                                    CUT)
    _eq(ct, cj)
    _eq(lt, lj)


@pytest.mark.parametrize("case", ["prm", "production"])
def test_config_matches_jax(case):
    if case == "prm":
        path = os.path.join(ROOT, "examples", "gaussian-charges.prm")
        t, j = TC.load_prm(path), JC.load_prm(path)
    else:
        t, j = (TC.production_scaling_config(1),
                JC.production_scaling_config(1))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("n", [1, 2])
def test_nacl_lattice_matches_jax(n):
    t, j = TA.nacl_lattice(n), JA.nacl_lattice(n)
    _eq(t.positions, j.positions)
    _eq(t.charges, j.charges)
    assert t.n == j.n == 8 * n ** 3


@pytest.mark.parametrize("dim, reps, seed", CASES)
@pytest.mark.parametrize("encoding", ["binary", "ascii"])
def test_vtu_output_matches_jax(tmp_path, dim, reps, seed, encoding):
    """io/vtu.py: the same bytes in every file, the same nodal gradient."""
    ft = _forests(TM, dim, reps, seed)[-1]
    fj = _forests(JM, dim, reps, seed)[-1]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(ft.dofs.n_dofs)
    gt, gj = TV.nodal_gradient(ft, u), JV.nodal_gradient(fj, u)
    _eq(gt, gj)
    cells = np.flatnonzero(rng.random(ft.n_cells) < 0.5)
    cell_data = {"subdomain": rng.integers(0, 3, ft.n_cells) * 1.0,
                 "error_indicator": rng.random(ft.n_cells)}
    out = {}
    for tag, mod, f, g in (("t", TV, ft, gt), ("j", JV, fj, gj)):
        piece = str(tmp_path / f"{tag}.0000.vtu")
        mod.write_vtu(piece, f, {"solution": u, "grad_phi": g}, cell_data,
                      cells=cells, encoding=encoding)
        mod.write_pvtu(str(tmp_path / f"{tag}.pvtu"), [piece],
                       point_names=["solution", "grad_phi"],
                       cell_names=list(cell_data))
        mod.write_visit_record(str(tmp_path / f"{tag}.visit"), [piece])
        out[tag] = [open(str(tmp_path / f"{tag}{ext}"), "rb").read()
                    .replace(f"{tag}.0000".encode(), b"P")
                    for ext in (".0000.vtu", ".pvtu", ".visit")]
    assert out["t"] == out["j"]


@pytest.mark.parametrize("with_mask", [False, True])
def test_gnuplot_output_matches_jax(tmp_path, with_mask):
    """io/gnuplot.py: the same two scripts, byte for byte."""
    ft = _forests(TM, 2, 12, 0)[-1]
    fj = _forests(JM, 2, 12, 0)[-1]
    mask = (np.random.default_rng(1).random((ft.n_cells, 5)) < 0.3
            if with_mask else None)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    TG.grid_output_debug(ft, mask, 3, 2, str(tmp_path / "t"))
    JG.grid_output_debug(fj, mask, 3, 2, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()
