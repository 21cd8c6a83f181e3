"""The harness end to end at 8 atoms on the CPU, as a rehearsal: the
plain versions of the kernels run, ``correct`` is decided, and no device
metric is written; without a card the command prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gmg_bench import cells, run
from gmg_bench.tests.conftest import TINY


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_on_the_cpu(tiny_root, trace):
    cell = cells.find_cell(TINY, tiny_root)
    result, checks = run.run_cell(cell, 2 ** 40 + 17, 0.5, trace,
                                  device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 2
    assert result["device"]["platform"] == "cpu"
    assert result["device"]["memory_peak_bytes"] is None
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert list(result)[-1] == "checks"
    names = set(result["metrics"])
    device_metrics = {m["name"] for m in cell.per_layer + cell.end_to_end
                      if m["source"] == "device_trace"}
    assert not names & device_metrics
    assert names & {"time_to_solution_s", "setup_s"} == set()
    if trace:
        assert {"stage.solve_s", "stage.refine_s",
                "solve.cg_iterations"} <= names
    assert checks["cells_off_published"]["value"] == 0


def _bench(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "gmg_bench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_no_result():
    p = _bench(["--workload", "nacl64k_f32.production", "--seed",
                str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"],
               cells.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.PKG, tmp_path / "gmg_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _bench(["--workload", "nacl1k_f64.production", "--seed", "1",
                "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_on_the_card(tiny_root, card):
    cell = cells.find_cell(TINY, tiny_root)
    result, _ = run.run_cell(cell, 7, 0.5, True, device=card)
    assert result["correct"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "ell_spmv_roofline" in result["metrics"]
    json.dumps(result)


test_a_run_on_the_card = pytest.mark.cuda(test_a_run_on_the_card)
