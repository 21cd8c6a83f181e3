"""The readings that the limit of ``residual_max`` is set from, on the chip
at a cell's own size.

    python -m gmg_bench.control --workload <cell> --seeds 1,2,3 \
        --dtype bfloat16 [--control-seeds 1,2,3] [--out FILE]

For every seed, one whole solve of the cell's lattice in that seed's first
atom order, and the comparison's ``residual_max`` of it (the lower
reading).  For every control seed, on each cycle's mesh of that solve,
the control: the plain reference put in the program's place and computed
in ``--dtype``, the precision below the configuration's (bfloat16 for
float32, float32 for float64), put in the snapshots in the program's
solution's place and judged by ``check.compare`` as the program is: its
``residual_max`` is the upper reading, and its ``correct`` has to come out
false.  The reference chooses no mesh, so the
control solves on the program's meshes.  Needs a CUDA card; the
benchmark's own runs never run this (the tests run its parts on the CPU
at 8 atoms).
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
from gmg_bench.reference import fem
from gmg_bench.reference.density import member_table
from gmg_bench.run import WARMUP_N, Solver

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def control_snapshots(snaps: list, pos, q, settings: dict, dtype, device,
                      maxiter: int) -> tuple:
    """(the snapshots ``snaps`` with each cycle's solution replaced by the
    control's, as host arrays at the mesh's vertices; CG iterations per
    cycle).  :func:`check.compare` judges them as it judges the
    program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    reps, lower, h0 = fem.base_grid(settings)
    P = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    Q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    r_c = settings["r_c"]
    cut = check.density_cut(settings, h0)
    members = member_table(reps, lower, h0, P, cut)
    out, its = [], []
    for s in snaps:
        mesh = fem.Mesh(reps, lower, h0, s["level"], s["ijk"], dev)
        uc, it = fem.control_solution(mesh, P, Q, r_c, cut, dtype,
                                      maxiter=maxiter, members=members)
        out.append(dict(s, positions=mesh.positions().cpu().numpy(),
                        solution=uc.cpu().numpy()))
        its.append(it)
        del mesh, uc
    return out, its


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--dtype", choices=sorted(DTYPES), required=True)
    ap.add_argument("--maxiter", type=int, default=4000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = "cuda"
    cell = cells.find_cell(args.workload)
    settings = inputs.settings(cell.config, cell.traffic)
    n = int(cell.config["lattice"]["n"])
    solver = Solver(settings, device)
    solver.solve(WARMUP_N, np.arange(8 * WARMUP_N ** 3))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    published = inputs.published_cells(cell.config, cell.traffic)
    rows = []
    for seed in seeds:
        order = inputs.Orders(seed, 8 * n ** 3).next()
        rec, snaps, atoms = solver.solve(n, order, snap=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checks, correct = check.compare(snaps, atoms.positions,
                                        atoms.charges, settings, published,
                                        cell.limits, 0, device, seed=seed,
                                        readers=cell.checks)
        row = {"seed": seed, "solve_s": rec["wall_s"], "cells": rec["cells"],
               "cg": rec["cg"], "program": checks["residual_max"]["value"],
               "correct": correct, "compare_s": time.perf_counter() - t0}
        if seed in controls:
            t0 = time.perf_counter()
            ctl, row["control_cg"] = control_snapshots(
                snaps, atoms.positions, atoms.charges, settings,
                DTYPES[args.dtype], device, args.maxiter)
            ctl_checks, row["control_correct"] = check.compare(
                ctl, atoms.positions, atoms.charges, settings, published,
                cell.limits, 0, device, seed=seed, readers=cell.checks)
            row["control"] = ctl_checks["residual_max"]["value"]
            row["control_dtype"] = args.dtype
            row["control_s"] = time.perf_counter() - t0
            del ctl
        print(json.dumps(row), flush=True)
        rows.append(row)
        del snaps
    low = max(r["program"] for r in rows)
    up = [r["control"] for r in rows if "control" in r]
    summary = {"workload": args.workload, "lower": low,
               "upper": min(up) if up else None, "seeds": len(rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
