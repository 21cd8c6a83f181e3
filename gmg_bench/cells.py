"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root names the cells; each part of a cell is a
file of its own:

* the configuration: the ``file`` of its entry in ``configs``;
* the traffic mix: ``gmg_bench/traffic/<traffic>.json``;
* the limits of the comparison: ``gmg_bench/limits/<cell>.json``;
* each per-layer metric: ``gmg_bench/metrics/<metric>.py``.

A later cell or metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's file
    limits: dict          # the comparison's limits for this cell
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: str = ROOT      # the checkout the files were found in


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``; KeyError if none."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    pkg = os.path.join(root, "gmg_bench")
    traffic = _json(os.path.join(pkg, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(pkg, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                root=root)


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``gmg_bench/metrics/<name>.py``."""
    path = os.path.join(root, "gmg_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gmg_bench.metrics._reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
