"""A cell, and every part of it, is found from its files by name; a new
cell or metric takes only new files and new entries."""

import json
import os

import pytest

from gmg_bench import cells
from gmg_bench.tests.conftest import TINY


def test_every_cell_of_the_benchmark_has_its_files():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert "residual_max" in cell.limits
        assert set(cell.checks) == set(cell.limits) - {"readings"} - set(
            cells.BUILT_IN_CHECKS)
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for k in cells.kernels().values():
        assert k.MODULE.startswith("coulomb_gmg_tpu_torch.") and k.DEVICE
        assert callable(k.bound_s) and isinstance(k.LAUNCHER, str)


def test_a_new_cell_and_metric_found_by_name(tiny_root):
    pkg = os.path.join(tiny_root, "gmg_bench")
    with open(os.path.join(pkg, "metrics", "solves.count.py"), "w") as fh:
        fh.write("def read(ctx):\n    return len(ctx['solves'])\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({"name": "solves.count", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "time_to_solution_s",
                               "workloads": [TINY]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    cell = cells.find_cell(TINY, tiny_root)
    assert cell.root == tiny_root and cell.config["lattice"]["n"] == 1
    assert cell.traffic["overrides"] == {}
    names = [m["name"] for m in cell.per_layer]
    assert "solves.count" in names and "stage.solve_s" in names
    read = cells.metric_reader("solves.count", tiny_root)
    assert read({"solves": [1, 2, 3]}) == 3


def test_an_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        cells.find_cell("nacl64k_f32.nowhere", tiny_root)
    with pytest.raises(FileNotFoundError):
        cells.load_benchmark(os.path.join(tiny_root, "gmg_bench"))
