"""The port's headline benchmark (coulomb_gmg_tpu_torch/bench.py) on the
CPU: its worker, gate, headline, budget and sweep at 8 atoms, and its
constants against the JAX package's ``bench.py`` and
``tools/bench_scaling.py``, read from their source (the port never
imports them).  The card run is tests/test_torch_cuda.py's."""

import ast
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from coulomb_gmg_tpu_torch import bench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS_8 = [85184, 85744, 87648, 91344, 99464]


def _env(**extra):
    env = dict(os.environ, BENCH_N="1", BENCH_RUNS="1", OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    env.pop("BENCH_FE", None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def cpu_run():
    """``python -m coulomb_gmg_tpu_torch.bench --device cpu`` at
    BENCH_N=1, one timed run: (exit code, BENCH_RUN records, headline)."""
    p = subprocess.run([sys.executable, "-m", "coulomb_gmg_tpu_torch.bench",
                        "--device", "cpu"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    runs = [json.loads(ln[len(bench.RUN_TAG):]) for ln in lines
            if ln.startswith(bench.RUN_TAG)]
    return p.returncode, runs, json.loads(lines[-1]), p.stderr


def test_worker_run_passes_its_gate(cpu_run):
    rc, runs, _, err = cpu_run
    assert rc == 0, err
    assert len(runs) == 1
    rec = runs[0]
    assert rec["atoms"] == 8 and rec["device"] == "cpu"
    assert rec["cells"] == CELLS_8
    assert all(r <= 1.01e-8 for r in rec["residual"])
    assert all(1 <= k <= 20 for k in rec["cg"])
    assert bench.gate(rec, "gpu", on_card=False) == []
    # the plain versions on the CPU launch no kernel
    assert set(rec["launches"]) == {"tile_density", "ell_spmv",
                                    "dense_density", "exact_gradient"}
    assert not any(rec["launches"].values())
    assert "Solve" in rec["stages_s"] and rec["peak_bytes"] is None


def test_cpu_headline_names_its_device(cpu_run):
    rc, runs, line, _ = cpu_run
    assert rc == 0
    assert line["metric"] == "walltime_8atom_5cycle_production_gmg_s_cpu"
    assert {"metric", "value", "unit", "vs_baseline", "runs", "min", "max",
            "device", "power_limit_w"} <= set(line)
    assert line["unit"] == "s" and line["device"] == "cpu"
    assert line["power_limit_w"] is None and line["failed"] == []
    assert line["runs"] == 1
    assert line["value"] == line["min"] == line["max"] == runs[0]["wall_s"]
    assert line["vs_baseline"] == pytest.approx(134.2 / line["value"])


def _record(**over):
    rec = {"config": "gpu", "atoms": 8, "wall_s": 2.0, "device": "cpu",
           "cells": list(CELLS_8), "dofs": [1] * 5, "cg": [2, 5, 7, 7, 8],
           "cg_passes": [[1, 1]] * 5, "residual": [1e-9] * 5, "fe": None,
           "stages_s": {}, "peak_bytes": None,
           "launches": {"tile_density": 5, "ell_spmv": 900,
                        "dense_density": 0, "exact_gradient": 0}}
    rec.update(over)
    return rec


DEFECTS = {
    "one cell count off": dict(cells=CELLS_8[:4] + [CELLS_8[4] + 1]),
    "residual 2e-8": dict(residual=[1e-9, 1e-9, 2e-8, 1e-9, 1e-9]),
    "residual NaN": dict(residual=[1e-9] * 4 + [math.nan]),
    "CG 0": dict(cg=[0, 5, 7, 7, 8]),
    "CG 21": dict(cg=[2, 5, 7, 21, 8]),
    "FE NaN": dict(atoms=8000, cells=bench.REF_CELLS[8000],
                   fe=[0.82, 0.80, math.nan, 0.65, 0.60]),
    "no tile launch": dict(launches={"tile_density": 0, "ell_spmv": 900,
                                     "dense_density": 0,
                                     "exact_gradient": 0}),
    "no ELL launch": dict(launches={"tile_density": 5, "ell_spmv": 0,
                                    "dense_density": 0,
                                    "exact_gradient": 0}),
}


def test_gate_accepts_a_valid_record():
    assert bench.gate(_record(), "gpu", on_card=True) == []
    fe = _record(atoms=8000, cells=bench.REF_CELLS[8000],
                 fe=[0.82, 0.80, 0.74, 0.65, 0.60],
                 launches={"tile_density": 5, "ell_spmv": 900,
                           "dense_density": 0, "exact_gradient": 12})
    assert bench.gate(fe, "gpu", on_card=True) == []
    # an unpublished size has no cells to equal
    assert bench.gate(_record(atoms=64, cells=[1, 2, 3, 4, 5]), "gpu",
                      on_card=False) == []


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_gate_rejects(defect, monkeypatch, capsys):
    """Each defect fails the gate, and the top level then prints an
    ``_INVALID`` headline and returns 1."""
    rec = _record(**DEFECTS[defect])
    assert bench.gate(rec, "gpu", on_card=True)
    monkeypatch.setenv("BENCH_N", str(round((rec["atoms"] / 8) ** (1 / 3))))
    monkeypatch.setenv("BENCH_RUNS", "3")
    monkeypatch.delenv("BENCH_FE", raising=False)
    monkeypatch.setattr(bench, "device_facts",
                        lambda device: (True, "a card", 700.0))
    good = _record(atoms=rec["atoms"], cells=bench.REF_CELLS[rec["atoms"]])
    monkeypatch.setattr(bench, "spawn_worker",
                        lambda *a: ([good, rec, good], None))
    assert bench.main(["--device", "cuda"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"].endswith("_gpu_INVALID")
    assert line["runs"] == 2 and line["value"] == 2.0
    assert line["failed"] and all(f.startswith("run 1:")
                                  for f in line["failed"])


def test_zero_launches_pass_only_off_the_card():
    rec = _record(launches=dict.fromkeys(bench.PATH_KERNELS["gpu"], 0))
    assert bench.gate(rec, "gpu", on_card=False) == []
    assert bench.gate(rec, "gpu", on_card=True)
    f64 = _record(config="gpu_f64",
                  launches={"tile_density": 0, "ell_spmv": 0})
    assert bench.gate(f64, "gpu_f64", on_card=True)
    f64["launches"]["ell_spmv"] = 3000
    assert bench.gate(f64, "gpu_f64", on_card=True) == []


def test_missing_runs_are_invalid():
    line, rc = bench.summarize([_record()], 3, "gpu", 8, False, False,
                               "cpu", None)
    assert rc == 1 and line["metric"].endswith("_cpu_INVALID")
    assert line["value"] == 2.0 and line["failed"] == ["1 of 3 runs finished"]
    line, rc = bench.summarize([_record(wall_s=w) for w in (3.0, 1.0, 2.0)],
                               3, "gpu_f64", 8, False, False, "cpu", None)
    assert rc == 0 and line["metric"].endswith("_cpu_f64")
    assert (line["value"], line["min"], line["max"]) == (2.0, 1.0, 3.0)


def test_worker_past_its_budget_is_killed(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_N", "1")
    monkeypatch.setenv("BENCH_RUNS", "1")
    monkeypatch.setenv("BENCH_BUDGET_S", "0.01")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    t0 = time.time()
    assert bench.main(["--device", "cpu"]) == 1
    assert time.time() - t0 < 60
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == ("walltime_8atom_5cycle_production_gmg_s_cpu"
                              "_INVALID")
    assert line["value"] is None and line["runs"] == 0
    assert "killed past its budget of 0.01 s" in line["failed"][0]


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_sweep_of_one_size(monkeypatch, capsys):
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_FE", raising=False)
    assert bench.main(["--device", "cpu", "--sizes", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if not
            ln.startswith(bench.RUN_TAG)]
    assert len(rows) == 1
    row = rows[0]
    assert row["atoms"] == 8 and row["cells_match_published"] is True
    assert row["cells_per_cycle"] == CELLS_8
    assert row["cells_final"] == CELLS_8[-1] and row["dofs_final"] == 109269
    assert row["valid"] and row["runs"] == 1 and row["device"] == "cpu"
    assert all(1 <= k <= 20 for k in row["cg_per_cycle"])
    assert row["ref_debug_s"] == 134.2
    assert row["speedup_vs_ref"] == pytest.approx(134.2 / row["wall_s"])


def _literal(path, name):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} not in {path}")


@pytest.mark.parametrize("path, name", [("bench.py", "BASELINES"),
                                        ("bench.py", "REF_CELLS"),
                                        ("tools/bench_scaling.py",
                                         "REF_DEBUG")])
def test_constants_equal_the_jax_side(path, name):
    assert getattr(bench, name) == _literal(path, name)
