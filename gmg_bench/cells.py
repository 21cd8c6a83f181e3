"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root names the cells; each part of a cell is a
file of its own:

* the configuration: the ``file`` of its entry in ``configs``;
* the traffic mix: ``gmg_bench/traffic/<traffic>.json``, with the cells
  published for it where it names them (``published_cells``);
* the limits of the comparison: ``gmg_bench/limits/<cell>.json``;
* each check of the comparison that is not one of :data:`BUILT_IN_CHECKS`:
  ``gmg_bench/checks/<key>.py``, one for each key of the limits;
* each per-layer metric: ``gmg_bench/metrics/<metric>.py``;
* each hand kernel whose launches are recorded and whose work is counted:
  ``gmg_bench/kernels/<kernel>.py``.

A later cell, check, kernel or metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# the checks that gmg_bench/check.py:compare computes itself; every other
# key of a cell's limits but ``readings`` names a file of gmg_bench/checks/
BUILT_IN_CHECKS = ("residual_max", "mesh_faults", "cells_off_published",
                   "dof_mismatch", "failed_solves")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's file
    limits: dict          # the comparison's limits for this cell
    checks: dict          # read(ctx) of each check of the limits' own
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
                checks=check_readers(limits, root),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                root=root)


def _module(kind: str, name: str, root: str):
    """The module ``gmg_bench/<kind>/<name>.py`` of the benchmark at
    ``root``; FileNotFoundError if there is none."""
    path = os.path.join(root, "gmg_bench", kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"gmg_bench.{kind}._file_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``gmg_bench/metrics/<name>.py``."""
    return _module("metrics", name, root).read


def own_checks(limits: dict) -> list:
    """The keys of ``limits`` that name a file of gmg_bench/checks/: all
    but ``readings`` and the built-in checks."""
    return [k for k in limits
            if k != "readings" and k not in BUILT_IN_CHECKS]


def check_readers(limits: dict, root: str = ROOT) -> dict:
    """``{key: read}`` of ``gmg_bench/checks/<key>.py`` for every key of
    :func:`own_checks`; a key without its file raises FileNotFoundError, so
    that it never passes."""
    return {k: _module("checks", k, root).read for k in own_checks(limits)}


def kernels(root: str = ROOT) -> dict:
    """``{kernel: module}`` of every ``gmg_bench/kernels/<kernel>.py``: the
    program's launcher (``MODULE``, ``LAUNCHER``), the names of its device
    functions (``DEVICE``) and the least time its work takes
    (``bound_s(args, kw)``)."""
    pkg = os.path.join(root, "gmg_bench", "kernels")
    names = sorted(f[:-3] for f in os.listdir(pkg)
                   if f.endswith(".py") and not f.startswith("_"))
    return {n: _module("kernels", n, root) for n in names}
