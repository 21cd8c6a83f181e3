"""A later configuration brings its own checks, kernels and published
cells as new files, found by name, with no edit to the harness: here the
reference's default run (FE error, volume-term Kelly, all-atom density)
on the 8-atom lattice, on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from gmg_bench import cells, check, inputs, run
from gmg_bench.reference import fem
from gmg_bench.reference.density import density_at, member_table
from gmg_bench.tests.conftest import TINY

DEFAULTS = {"flag_postprocess_error": True, "estimator_volume_term": True,
            "flag_rhs_assembly": False}
FE_MISSING = ("def read(ctx):\n"
              "    return sum(s['energy_norm_error'] is None\n"
              "               for s in ctx['snapshots'])\n")
FE_MAX = ("def read(ctx):\n"
          "    return max(s['energy_norm_error'] for s in ctx['snapshots'])\n")


def tiny_settings(**over) -> dict:
    cfg = cells.find_cell("nacl64k_f32.production").config
    return {**cfg["settings"], "domain_right": 1.0, "n_adaptive_cycles": 2,
            **over}


@pytest.fixture(scope="module")
def fe_solve():
    s = tiny_settings(**DEFAULTS)
    order = inputs.Orders(31415926535897, 8).next()
    rec, snaps, atoms = run.Solver(s, "cpu").solve(1, order, snap=True)
    return s, rec, snaps, atoms


def write(root, kind, name, text):
    path = os.path.join(root, "gmg_bench", kind, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(text)


def test_the_snapshots_carry_each_cycles_outputs(fe_solve):
    _, rec, snaps, _ = fe_solve
    assert len(snaps) == 2
    for s, cg in zip(snaps, rec["cg"]):
        assert s["energy_norm_error"] > 0
        assert s["cg_iterations"] == cg
        assert s["n_dofs"] > 0 and s["threshold"] is not None
    s = tiny_settings(n_adaptive_cycles=1)
    _, snaps, _ = run.Solver(s, "cpu").solve(1, np.arange(8), snap=True)
    assert snaps[0]["energy_norm_error"] is None


def test_a_check_by_name_enters_correct(tmp_path, fe_solve):
    s, _, snaps, atoms = fe_solve
    write(tmp_path, "checks", "fe_missing.py", FE_MISSING)
    write(tmp_path, "checks", "fe_max.py", FE_MAX)
    limits = {"residual_max": 1e-3, "fe_missing": 0, "fe_max": 10.0,
              "readings": {}}
    readers = cells.check_readers(limits, str(tmp_path))
    assert set(readers) == {"fe_missing", "fe_max"}
    checks, correct = check.compare(snaps, atoms.positions, atoms.charges,
                                    s, None, limits, 0, "cpu", seed=3,
                                    readers=readers)
    assert correct, checks
    assert checks["fe_missing"] == {"value": 0.0, "limit": 0}
    assert 0 < checks["fe_max"]["value"] < 10.0
    assert checks["residual_max"]["value"] < 3e-7
    checks, correct = check.compare(
        snaps, atoms.positions, atoms.charges, s, None,
        dict(limits, fe_max=1e-12), 0, "cpu", readers=readers)
    assert not correct and checks["fe_max"]["limit"] == 1e-12


def test_a_limit_without_its_check_never_passes(tiny_root, fe_solve):
    path = os.path.join(tiny_root, "gmg_bench", "limits", TINY + ".json")
    with open(path) as fh:
        limits = json.load(fh)
    limits["fe_nowhere"] = 1.0
    with open(path, "w") as fh:
        json.dump(limits, fh)
    with pytest.raises(FileNotFoundError):
        cells.find_cell(TINY, tiny_root)
    s, _, snaps, atoms = fe_solve
    with pytest.raises(KeyError):
        check.compare(snaps, atoms.positions, atoms.charges, s, None,
                      limits, 0, "cpu")


def test_the_density_without_the_locality_cut_sums_every_atom():
    pos, q = (torch.from_numpy(a) for a in inputs.lattice(1))
    reps, lower, h0 = fem.base_grid(tiny_settings())
    mesh = fem.Mesh(reps, lower, h0, np.zeros(reps ** 3, np.int32),
                    np.indices((reps,) * 3).reshape(3, -1).T)
    x = mesh.quad_points()
    r2 = ((x[:, :, None, :] - pos[None, None]) ** 2).sum(-1)
    want = (torch.exp(-r2 / 0.25) * q).sum(-1) * 4 / (0.125 * np.pi ** 0.5)
    for flag, within in ((False, lambda e: e <= 1e-14),
                         (True, lambda e: e > 1e-9)):
        s = tiny_settings(flag_rhs_assembly=flag)
        cut = check.density_cut(s, h0)
        rho = density_at(mesh, member_table(reps, lower, h0, pos, cut), pos,
                         q, s["r_c"])
        err = float((rho - want).abs().max() / want.abs().max())
        assert within(err), (flag, err)


@pytest.mark.parametrize("published, correct", [
    ([85184, 85744], True), ([85184, 85745], False), (None, True)])
def test_a_traffics_published_cells_replace_the_configurations(
        tiny_root, published, correct):
    cfg_path = os.path.join(tiny_root, "gmg_bench", "configs", "tiny.json")
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    # the configuration's list is wrong where the traffic's is right, and
    # right where it is wrong: only the traffic's can decide
    cfg["published_cells"] = [85184, 85745] if correct else [85184, 85744]
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    write(tiny_root, "traffic", "production.json", json.dumps(
        {"overrides": {}, "published_cells": published}))
    cell = cells.find_cell(TINY, tiny_root)
    result, checks = run.run_cell(cell, 2 ** 35 + 3, 0.1, False,
                                  device="cpu")
    assert result["correct"] is correct
    off = checks["cells_off_published"]["value"]
    assert (off == 0) is correct
    assert (result["failed"] == 0) is correct


def test_a_later_configuration_takes_only_new_files(tiny_root):
    pkg = os.path.join(tiny_root, "gmg_bench")
    before = {f: open(os.path.join(cells.PKG, f)).read()
              for f in ("check.py", "run.py", "trace.py",
                        "metrics/_roofline.py")}
    shutil.copy(os.path.join(pkg, "configs", "tiny.json"),
                os.path.join(pkg, "configs", "tiny_fe.json"))
    write(tiny_root, "traffic", "fe_defaults.json", json.dumps(
        {"overrides": DEFAULTS, "published_cells": None}))
    write(tiny_root, "limits", "tiny_fe.fe_defaults.json", json.dumps(
        {"residual_max": 1e-3, "fe_missing": 0}))
    write(tiny_root, "checks", "fe_missing.py", FE_MISSING)
    write(tiny_root, "kernels", "plain_gradient.py",
          "MODULE = 'coulomb_gmg_tpu_torch.ops.gradient'\n"
          "LAUNCHER = 'exact_gradient_plain'\n"
          "DEVICE = ('exact_gradient_plain',)\n\n"
          "def bound_s(args, kw):\n    return 1.0\n")
    write(tiny_root, "metrics", "plain_gradient.launches.py",
          "def read(ctx):\n"
          "    log = ctx['trace']['log']\n"
          "    return sum(log.weight(g) for _, _, g in\n"
          "               log.calls['plain_gradient']) or None\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(bench["configs"][0], name="tiny_fe",
                                 file="gmg_bench/configs/tiny_fe.json"))
    bench["workloads"].append({"name": "tiny_fe.fe_defaults",
                               "config": "tiny_fe", "traffic": "fe_defaults",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "plain_gradient.launches", "unit": "launches",
        "better": "lower", "source": "program_counter", "layer": "x",
        "moves": "setup_s", "workloads": ["tiny_fe.fe_defaults"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    cell = cells.find_cell("tiny_fe.fe_defaults", tiny_root)
    result, checks = run.run_cell(cell, 2 ** 41 + 9, 0.1, True,
                                  device="cpu")
    assert result["correct"], checks
    assert checks["fe_missing"] == {"value": 0.0, "limit": 0}
    assert checks["cells_off_published"]["value"] == 0
    assert result["metrics"]["plain_gradient.launches"]["value"] >= 2
    assert before == {f: open(os.path.join(cells.PKG, f)).read()
                      for f in before}
