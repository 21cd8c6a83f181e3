"""The default-run cell (``nacl64k_fe_f32.production``: all-atom density,
volume-term Kelly, the FE error of every cycle) finds its checks and
metrics by name; its metrics read None where the program has no such span
or counter; its reference imports nothing of the program; and the cell
runs end to end at 8 atoms on the CPU."""

import collections
import json
import os
import subprocess
import sys

import pytest

from gmg_bench import cells, run
from gmg_bench.tests.conftest import make_root

CELL = "nacl64k_fe_f32.production"
CHECKS = {"fe_error_rel", "threshold_rel", "marks_missed", "splits_unmarked"}
SPAN_METRICS = ("fe.gradient_s.fe64k", "fe.gradient_gpairs.fe64k",
                "estimate.volume_s.fe64k")
TRACE_METRICS = ("exact_gradient_roofline", "dense_density_roofline",
                 "device.idle_pct.fe64k")


def test_the_cells_checks_and_metrics_load_by_name():
    cell = cells.find_cell(CELL)
    assert set(cell.checks) == CHECKS
    assert {"residual_max"} | CHECKS <= set(cell.limits)
    assert cell.config["published_cells"] is None
    for k in ("flag_rhs_assembly", "estimator_volume_term",
              "flag_postprocess_error"):
        assert cell.config["settings"][k] is (k != "flag_rhs_assembly")
    names = {m["name"] for m in cell.per_layer}
    assert set(SPAN_METRICS + TRACE_METRICS) <= names
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "peak_device_gib"
        assert callable(cells.metric_reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} == {"peak_device_gib",
                                                    "setup_s"}


def test_without_the_programs_spans_the_metrics_read_none(monkeypatch):
    from coulomb_gmg_tpu_torch.utils import timer
    runs = collections.deque(
        [{"cells": [8], "spans": {"run": {"total_s": 1.0}}, "counters": {}}]
        * 2, maxlen=64)
    monkeypatch.setattr(timer, "RUNS", runs)
    log = type("Log", (), {"calls": {}, "kernels": {}})()
    ctx = {"solves": [{"cells": [8], "stages": {"Solve": 1.0}}],
           "window_s": 2.0,
           "trace": {"kernel_s": {}, "log": log, "busy_s": 0.0,
                     "window_s": 1.0}}
    for name in SPAN_METRICS + TRACE_METRICS + (
            "stage.fe_error_s.fe64k", "stage.density_s.fe64k",
            "stage.estimate_s.fe64k"):
        assert cells.metric_reader(name)(ctx) is None, name
    assert cells.metric_reader("solve.wall_s.fe64k")(ctx) == 2.0
    assert cells.metric_reader("exact_gradient_roofline")({}) is None


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import gmg_bench.reference.fe_error, gmg_bench.reference.kelly\n"
        "from gmg_bench import cells\n"
        f"cells.check_readers(cells.find_cell({CELL!r}).limits)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    tops = json.loads(out.splitlines()[-1])
    assert "torch" in tops
    for bad in run.FORBIDDEN + ("coulomb_gmg_tpu_torch",):
        assert bad not in tops, bad


@pytest.fixture
def fe_root(tmp_path):
    """The tiny benchmark root, its one cell given the default-run
    configuration and limits on the 8-atom lattice over two cycles."""
    root = make_root(tmp_path)
    pkg = os.path.join(root, "gmg_bench")
    with open(os.path.join(cells.PKG, "configs", "nacl64k_fe_f32.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny"
    cfg["lattice"].update(n=1, atoms=8)
    cfg["settings"].update(domain_right=1.0, n_adaptive_cycles=2)
    with open(os.path.join(pkg, "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(cells.PKG, "limits", CELL + ".json")) as fh:
        limits = json.load(fh)
    with open(os.path.join(pkg, "limits", "tiny.production.json"),
              "w") as fh:
        json.dump(limits, fh)
    return root


def test_the_cell_rehearsed_on_the_cpu(fe_root):
    cell = cells.find_cell("tiny.production", fe_root)
    assert set(cell.checks) == CHECKS
    result, checks = run.run_cell(cell, 2 ** 40 + 77, 0.1, True,
                                  device="cpu")
    assert result["correct"], checks
    assert checks["marks_missed"]["value"] == 0
    assert checks["splits_unmarked"]["value"] == 0
    assert checks["fe_error_rel"]["value"] < 1e-5
    names = set(result["metrics"])
    assert {"stage.fe_error_s.fe64k", "fe.gradient_s.fe64k",
            "fe.gradient_gpairs.fe64k", "estimate.volume_s.fe64k",
            "stage.density_s.fe64k", "solve.wall_s.fe64k"} <= names
    assert not names & set(TRACE_METRICS)
    pairs = result["metrics"]["fe.gradient_gpairs.fe64k"]["value"]
    assert pairs >= 8 * 8 * 2 * 85184 / 1e9      # points x atoms, 2 cycles
