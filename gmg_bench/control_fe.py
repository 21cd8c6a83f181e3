"""The readings that the limits of ``fe_error_rel`` and ``threshold_rel``
and the band ``DELTA`` of the marking checks are set from, on the chip at
a cell's own size.

    python -m gmg_bench.control_fe --workload <cell> --seeds 1,2,3 \
        --dtype bfloat16 [--control-seeds 1,2,3] [--out FILE]

For every seed, one whole solve of the cell's lattice in that seed's first
atom order, judged by ``check.compare`` as a run judges it: its
``fe_error_rel``, ``threshold_rel``, ``marks_missed`` and
``splits_unmarked`` (the lower readings), and ``band``: the largest
``|eta_program - eta_ref| / theta_ref`` over the cells of every cycle, the
program's indicator recorded as its estimate returns it, the reference's
that of gmg_bench/reference/kelly.py (DELTA's reading).  For every control
seed, the reference recomputes the FE error of the program's own solution
and its indicator with the exact gradient and the density in ``--dtype``,
the precision below the configuration's (bfloat16 for float32); these go
in the snapshots in place of the program's ``energy_norm_error`` and
``threshold``, and ``check.compare`` judges them as it judges the program:
their readings are the upper ones, and ``correct`` has to come out false.
Needs a CUDA card; the benchmark's own runs never run this (the tests run
its parts on the CPU).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from gmg_bench import cells, check, inputs
from gmg_bench.checks.fe_error_rel import cycle_of
from gmg_bench.control import DTYPES
from gmg_bench.reference import fe_error, fem, kelly
from gmg_bench.reference.density import density_at, member_table
from gmg_bench.run import WARMUP_N, Solver

CHECKS = ("fe_error_rel", "threshold_rel", "marks_missed", "splits_unmarked")


def references(snaps: list, pos, q, settings: dict, device,
               dtype=torch.float64):
    """Each cycle's ``(mesh, vertex values, eta, theta)`` of the reference,
    the density in ``dtype``."""
    dev = torch.device(device)
    reps, lower, h0 = fem.base_grid(settings)
    P = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    Q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    members = member_table(reps, lower, h0, P,
                           check.density_cut(settings, h0))
    for s in snaps:
        mesh = fem.Mesh(reps, lower, h0, s["level"], s["ijk"], dev)
        u, _ = fem.vertex_values(mesh, s["positions"], s["solution"])
        rho = density_at(mesh, members, P, Q, settings["r_c"], dtype=dtype)
        eta = kelly.indicator(mesh, u, rho,
                              settings["estimator_volume_term"])
        yield mesh, u, eta, settings["refine_fraction_of_max"] * float(
            eta.max())


def band(snaps: list, etas: list, pos, q, settings: dict, device) -> float:
    """The largest ``|eta_program - eta_ref| / theta_ref`` over every cell
    of every cycle."""
    worst = 0.0
    for (_, _, eta, theta), got in zip(
            references(snaps, pos, q, settings, device), etas):
        worst = max(worst, float((got.to(eta.device) - eta).abs().max())
                    / theta)
    return worst


def control_snapshots(snaps: list, pos, q, settings: dict, dtype, device,
                      seed: int) -> list:
    """The snapshots ``snaps`` with each cycle's ``threshold`` replaced by
    the reference's with the density in ``dtype``, and the
    ``energy_norm_error`` of the cycle that ``fe_error_rel`` compares by
    the reference's with the exact gradient in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = cycle_of(seed, len(snaps))
    out = []
    for c, (mesh, u, _, theta) in enumerate(
            references(snaps, pos, q, settings, device, dtype)):
        shot = dict(snaps[c], threshold=theta)
        if c == k:
            shot["energy_norm_error"] = fe_error.energy_norm_error(
                mesh, u, pos, q, settings["r_c"], dtype=dtype)
        out.append(shot)
        del mesh, u
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--dtype", choices=sorted(DTYPES), required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_fe: needs a CUDA card", file=sys.stderr)
        return 2
    device = "cuda"
    cell = cells.find_cell(args.workload)
    settings = inputs.settings(cell.config, cell.traffic)
    n = int(cell.config["lattice"]["n"])
    solver = Solver(settings, device)
    etas = []
    orig = solver.Simulation.estimate_and_mark

    def recording(sim):
        orig(sim)
        etas.append(sim.error_per_cell.detach().cpu())

    solver.Simulation.estimate_and_mark = recording
    solver.solve(WARMUP_N, np.arange(8 * WARMUP_N ** 3))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    published = inputs.published_cells(cell.config, cell.traffic)
    rows = []
    for seed in seeds:
        order = inputs.Orders(seed, 8 * n ** 3).next()
        etas.clear()
        rec, snaps, atoms = solver.solve(n, order, snap=True)
        gc.collect()
        torch.cuda.empty_cache()
        pos, q = atoms.positions, atoms.charges
        t0 = time.perf_counter()
        checks, correct = check.compare(snaps, pos, q, settings, published,
                                        cell.limits, 0, device, seed=seed,
                                        readers=cell.checks)
        row = {"seed": seed, "solve_s": rec["wall_s"], "cells": rec["cells"],
               "compare_s": time.perf_counter() - t0, "correct": correct,
               "program": {k: checks[k]["value"]
                           for k in CHECKS + ("residual_max",)},
               "energy_norm_error": [s["energy_norm_error"] for s in snaps],
               "threshold": [s["threshold"] for s in snaps]}
        t0 = time.perf_counter()
        row["band"] = band(snaps, etas, pos, q, settings, device)
        row["band_s"] = time.perf_counter() - t0
        if seed in controls:
            t0 = time.perf_counter()
            ctl = control_snapshots(snaps, pos, q, settings,
                                    DTYPES[args.dtype], device, seed)
            ctl_checks, row["control_correct"] = check.compare(
                ctl, pos, q, settings, published, cell.limits, 0, device,
                seed=seed, readers=cell.checks)
            row["control"] = {k: ctl_checks[k]["value"] for k in CHECKS}
            row["control_dtype"] = args.dtype
            row["control_s"] = time.perf_counter() - t0
            del ctl
        print(json.dumps(row), flush=True)
        rows.append(row)
        del snaps
    summary = {"workload": args.workload, "seeds": len(rows),
               "band": max(r["band"] for r in rows)}
    for k in CHECKS:
        summary[k] = {"lower": max(r["program"][k] for r in rows),
                      "upper": min((r["control"][k] for r in rows
                                    if "control" in r), default=None)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
