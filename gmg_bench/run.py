"""One run of one cell of the benchmark.

    python -m gmg_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  A run:

1. finds the cell's configuration, traffic mix, limits and metrics by name
   (gmg_bench/cells.py) and exits 2, printing no result, without enough
   CUDA cards;
2. sets up: imports the program, starts CUDA and runs one warm-up solve of
   the 8-atom lattice, which loads every kernel library (built into
   ``build/`` of the checkout by its first run) and library handle; the
   seconds from the process's start to here are ``setup_s``;
3. measures: whole solves of the configuration's lattice back to back, one
   client, each with its atoms in an order drawn from the seed and each
   from ``Simulation(...)`` to the end of ``run()`` with the card
   synchronized, until ``--seconds`` have passed (at least ``MIN_SOLVES``);
   ``time_to_solution_s`` is the window's wall time over the solves it
   completed and ``peak_device_gib`` the allocator's peak over the window;
4. with ``--trace 1``, runs one more solve under ``torch.profiler``
   (gmg_bench/trace.py) and reads the per-layer metrics;
5. frees the program's state and compares the sampled solve with the plain
   reference (gmg_bench/check.py); prints each number compared beside its
   limit as its last lines on standard error;
6. exits 3, printing no result, if ``jax``, ``jaxlib``, ``flax`` or
   ``coulomb_gmg_tpu`` was loaded; else prints the result as one JSON line,
   the last of standard output.
"""

from __future__ import annotations

import time

T_START = time.time()     # the process's start, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from gmg_bench import cells, inputs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "coulomb_gmg_tpu")
# the scalar outputs of each cycle of ``run()`` that a snapshot keeps
SCALARS = ("n_dofs", "threshold", "cg_iterations", "energy_norm_error")
WARMUP_N = 1      # the warm-up solve's lattice: 8 n^3 = 8 atoms
MIN_SOLVES = 2    # the least number of solves a window holds


def log(msg: str) -> None:
    print(f"[gmg_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class CardFacts:
    """``name, power.limit`` of the first card, as nvidia-smi gives them,
    asked at once and read at the end, so that set-up does not wait."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def read(self) -> str:
        if self.proc is None:
            return "unknown"
        try:
            out, _ = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return "unknown"
        return out.splitlines()[0].strip() if out else "unknown"


class Snapshots:
    """What the sampled solve produced in each cycle, taken when its
    estimate starts: the active cells, the solution and the DoF positions,
    each copied to the host as it is taken, so that no card memory is held
    past the cycle that made it; once the solve has ended, each cycle's
    scalar outputs of ``run()`` join them (:data:`SCALARS`, None where the
    program computed none)."""

    def __init__(self, sim):
        import torch
        self.cycles = []
        orig = sim.estimate_and_mark

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

        def estimate_and_mark():
            dofs = sim.forest.dofs_of(sim.cfg.degree)
            pos = dofs.host.__dict__.get("positions", dofs.positions)
            self.cycles.append({"level": host(sim.forest.level),
                                "ijk": host(sim.forest.ijk),
                                "solution": host(sim.solution),
                                "positions": host(pos)})
            return orig()
        sim.estimate_and_mark = estimate_and_mark

    def add_results(self, res: list) -> None:
        for shot, r in zip(self.cycles, res):
            shot.update({k: r.get(k) for k in SCALARS})


class Solver:
    """The program under test, as a user calls it."""

    def __init__(self, settings: dict, device: str):
        import torch
        from coulomb_gmg_tpu_torch.config import Config
        from coulomb_gmg_tpu_torch.driver import Simulation
        from coulomb_gmg_tpu_torch.io.lammps import AtomData
        from coulomb_gmg_tpu_torch.utils.logging import Pcout
        self.torch, self.Config, self.Simulation = torch, Config, Simulation
        self.AtomData, self.Pcout = AtomData, Pcout
        self.settings, self.device = settings, device

    def atoms(self, n: int, order):
        pos, q = inputs.lattice(n)
        pos, q = pos[order], q[order]
        return self.AtomData(positions=pos, charges=q,
                             types=np.where(q > 0, 1, 2).astype(np.int32),
                             box_lo=np.zeros(3), box_hi=np.full(3, float(n)))

    def solve(self, n: int, order, snap: bool = False, spans: bool = False):
        """One whole solve of the ``8 n^3``-atom lattice listed in
        ``order``: its record, and its snapshots where ``snap``."""
        from gmg_bench.trace import Spans
        s = dict(self.settings, domain_right=float(n),
                 domain_left=0.0, lammps_file=f"atom_n{n}_{8 * n ** 3}.data")
        cfg = self.Config(**s)
        atoms = self.atoms(n, order)
        t0 = time.perf_counter()
        sim = self.Simulation(cfg, atoms=atoms, device=self.device,
                              pcout=self.Pcout(enabled=False))
        shots = Snapshots(sim) if snap else None
        if spans:
            Spans(sim)
        res = sim.run()
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if shots is not None:
            shots.add_results(res)
        stages = {}
        for r in res:
            for k, v in r["stages"].items():
                stages[k] = stages.get(k, 0.0) + v
        rec = {"wall_s": wall, "cells": [r["n_cells"] for r in res],
               "cg": [r["cg_iterations"] for r in res],
               "residual": [r["residual"] / r["l2_rhs"] for r in res],
               "stages": stages}
        del sim, res
        return rec, (shots.cycles if shots else None), atoms


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> tuple:
    """Set up, measure, trace and compare one run of ``cell``; returns
    (result line, checks).  ``device="cpu"`` rehearses the run on the
    plain versions of the kernels and reports no device metric."""
    import torch
    from gmg_bench import check
    on_card = torch.device(device).type == "cuda"
    t_imp = time.time()
    settings = inputs.settings(cell.config, cell.traffic)
    n = int(cell.config["lattice"]["n"])
    solver = Solver(settings, device)
    t_ctx = time.time()
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
    t_warm = time.time()
    solver.solve(WARMUP_N, np.arange(8 * WARMUP_N ** 3))
    gc.collect()
    t_set = time.time()
    setup_s = t_set - T_START
    log(f"setup {setup_s:.3f} s: to the harness {t_imp - T_START:.3f}, "
        f"program import {t_ctx - t_imp:.3f}, CUDA start "
        f"{t_warm - t_ctx:.3f}, warm-up solve ({8 * WARMUP_N ** 3} atoms) "
        f"{t_set - t_warm:.3f}")

    orders = inputs.Orders(seed, 8 * n ** 3)
    sample = inputs.sample_index(seed, MIN_SOLVES)
    published = inputs.published_cells(cell.config, cell.traffic)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    solves, shots, sampled_atoms = [], None, None
    t0 = time.perf_counter()
    while len(solves) < MIN_SOLVES or time.perf_counter() - t0 < seconds:
        i = len(solves)
        rec, snap, atoms = solver.solve(n, orders.next(), snap=i == sample)
        if snap is not None:
            shots, sampled_atoms = snap, atoms
        solves.append(rec)
        gc.collect()
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    for i, r in enumerate(solves):
        log(f"solve {i}: {r['wall_s']:.3f} s, cells {r['cells']}, "
            f"CG {r['cg']}, stages "
            + ", ".join(f"{k.split(',')[0]} {v:.3f}"
                        for k, v in r["stages"].items()))
    failed = 0
    for i, r in enumerate(solves):
        why = check.solve_failures(r, settings, published)
        failed += bool(why)
        for w in why:
            log(f"solve {i}: {w}")

    traced, metrics = None, {}
    if trace:
        traced = traced_solve(solver, n, orders.next(), cell.root)
        ctx = {"solves": solves, "window_s": window, "trace": traced}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        del ctx, traced["log"]       # the traced solve's operators
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_cmp = time.perf_counter()
    checks, correct = check.compare(shots, sampled_atoms.positions,
                                    sampled_atoms.charges, settings,
                                    published, cell.limits, failed, device,
                                    seed=seed, readers=cell.checks)
    log(f"comparison of solve {sample}: {time.perf_counter() - t_cmp:.3f} s")

    if not trace and on_card:
        e2e = {"time_to_solution_s": window / len(solves),
               "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": cell.chips if on_card else 0,
                         "memory_peak_bytes": peak}}
    if traced is not None and on_card:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result, checks


def traced_solve(solver: Solver, n: int, order, root: str) -> dict:
    """One more whole solve under the profiler, every launch of the kernels
    of the benchmark at ``root`` recorded; the trace reduced
    (gmg_bench/trace.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from gmg_bench import trace
    log_ = trace.LaunchLog(root)
    span = trace.SPAN + "solve"
    with log_, profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            rec, _, _ = solver.solve(n, order, spans=True)
    t0 = time.perf_counter()
    out = trace.reduce(prof, span, log_.kernels)
    del prof
    out["log"] = log_
    out["record"] = rec
    log(f"traced solve {rec['wall_s']:.3f} s (busy {out['busy_s']:.3f} s of "
        f"{out['window_s']:.3f} s), trace read in "
        f"{time.perf_counter() - t0:.3f} s; kernel events "
        f"{out['kernel_events']}, launches recorded "
        f"{ {k: sum(log_.weight(g) for _, _, g in v) for k, v in log_.calls.items()} }")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch sees {have}: no result")
        return 2
    facts = CardFacts()
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    log(f"{args.workload} seed {args.seed}: {facts.read()}; peaks "
        "67 TFLOP/s float32, 3.35 TB/s")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}; no result")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
