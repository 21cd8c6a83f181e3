"""The V-cycle and the solves of the 8,000-atom system, piece by piece.

    python -m coulomb_gmg_tpu_torch.profile_pieces [--n 10] [--cycles 1]
        [--device cuda|cpu]

Counterpart of ``tools/profile_fused_pieces.py``,
``tools/bench_fused_solve.py`` and ``tools/profile_gathers.py``.  It runs
``production_scaling_config(n, dtype="float32", solver_backend="tpu_cg",
n_adaptive_cycles=cycles)`` twice, once with ``device_operators="on"``
and once ``"off"``, and takes the last cycle's system of each (cycle 0 by
default, a single level whose coarse solve is the DST; ``--cycles 5``
gives the published study's last mesh and its levels).  One JSON line
each:

1. ``piece``: each piece of the device-operator V-cycle
   (solver/gmg.py), on the vectors of one V-cycle of the system's RHS:
   ``cellwise_mv``, ``copy_to`` and ``copy_back`` (the copy maps of all
   levels), the DST coarse apply (``coarse``), and per level l >= 1 the
   ELL apply of ``A``, the pre-smoother (``cheb``, Chebyshev from zero),
   ``R``, ``P``, ``if`` and ``ifT`` where the level has them, and the
   level's whole share of the V-cycle (``down``: pre-smooth, residual,
   restriction; ``up``: prolongation, post-smooth); then ``vcycle``.
   Each timed eagerly (``eager_ms``: CUDA events around back-to-back
   calls, the host's launches included) and as a CUDA graph of
   back-to-back calls replayed in turns with the others (``graph_ms``,
   device time only); ``check`` sums the levels' shares with the coarse
   solve and the copy maps against the V-cycle, both ways;
2. ``solve``: the driver's solve of that system
   (solver/device_gmg.py:solve_refined_device from zero): ``eager``
   (``solve_fused=False``), ``stepped_cold`` (warm-up and capture of the
   stepped solve's graphs, then the solve) and ``stepped_hot`` (replays);
   their CG counts and solutions must agree, bit for bit;
3. ``host_solve``: the host-assembled float32 ``TpuGMG`` (solver/tpu_gmg.py)
   of the ``"off"`` run: its build with an empty host cache (``build``)
   and again with the first build's cache (``rebuild``, as the driver
   builds it from cycle to cycle), one solve to 1e-6 as the eager loop
   (``eager``, the second of two) and stepped (``stepped_cold``,
   ``stepped_hot``);
4. ``matvec``: the system matvec in its cellwise form beside the
   host-assembled system of the same mesh as an ELL, sliced (the layout
   the port gives it) and padded (K = 27 on a uniform mesh), at the same
   row count, eager and as graphs.

On the card unless ``--device cpu`` (without a card it raises); on the
CPU nothing is captured (``graph_ms`` null) and every time is the CPU's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from coulomb_gmg_tpu_torch.bench_kernels import (REPS, device_name,
                                                 graph_samples, time_samples,
                                                 wall_s)


def system(n: int, cycles: int, device, device_operators: str):
    """The finished ``Simulation`` of the profiled configuration."""
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    cfg = production_scaling_config(n, dtype="float32",
                                    solver_backend="tpu_cg",
                                    n_adaptive_cycles=cycles,
                                    device_operators=device_operators)
    sim = Simulation(cfg, atoms=nacl_lattice(n), device=device,
                     pcout=Pcout(enabled=False))
    sim.run()
    return sim


def vcycle_pieces(ops: dict, g: torch.Tensor) -> tuple:
    """(pieces, shares): name -> (level, callable) for every piece of the
    V-cycle on the residual ``g``, and the names whose sum is one
    V-cycle."""
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.solver.gmg import (_smooth, cellwise_mv,
                                                  coarse_apply, coarse_cg,
                                                  vcycle, vcycle_down)
    levels = ops["levels"]
    L = len(levels) - 1
    defect, sol = vcycle_down(ops, g)
    if ops["dst"] is not None:
        coarse = lambda: coarse_apply(ops["dst"], defect[0],
                                      levels[0]["inv_diag"], ops["dim"])
    else:
        coarse = lambda: coarse_cg(ops, defect[0])
    sol[0] = coarse()

    def copy_back():
        out = torch.zeros_like(g)
        for l in range(L + 1):
            idx = ops["src_idx"].clamp(max=sol[l].numel() - 1)
            out = torch.where(ops["src_lvl"] == l, sol[l][idx], out)
        return out

    def down(l):
        lv = levels[l]
        u = _smooth(lv, defect[l], None, True)
        r = defect[l] - ell_mv(*lv["A"], u)
        if lv["if"] is not None:
            r = r - ell_mv(*lv["if"], u)
        return defect[l - 1] + ell_mv(*lv["R"], r)

    def up(l):
        lv = levels[l]
        u = sol[l] + ell_mv(*lv["P"], sol[l - 1])
        d = defect[l]
        if lv["ifT"] is not None:
            d = d - ell_mv(*lv["ifT"], u)
        return _smooth(lv, d, u, False)

    pieces = {
        "cellwise_mv": (None, lambda: cellwise_mv(ops["sys"], g)),
        "copy_to": (None, lambda: [torch.where(lv["cmask"], g[lv["l2g"]],
                                               0.0) for lv in levels]),
        "copy_back": (None, copy_back),
        "coarse": (0, coarse)}
    for l in range(1, L + 1):
        lv = levels[l]
        ops_l = {"A": (lv["A"], defect[l]), "R": (lv["R"], defect[l]),
                 "P": (lv["P"], sol[l - 1]), "if": (lv["if"], sol[l]),
                 "ifT": (lv["ifT"], sol[l])}
        pieces[f"L{l} A"] = (l, lambda l=l: ell_mv(*levels[l]["A"],
                                                   defect[l]))
        pieces[f"L{l} cheb"] = (l, lambda lv=lv, l=l: _smooth(
            lv, defect[l], None, True))
        for key in ("R", "P", "if", "ifT"):
            op, x = ops_l[key]
            if op is not None:
                pieces[f"L{l} {key}"] = (l, lambda op=op, x=x: ell_mv(*op, x))
        pieces[f"L{l} down"] = (l, lambda l=l: down(l))
        pieces[f"L{l} up"] = (l, lambda l=l: up(l))
    pieces["vcycle"] = (None, lambda: vcycle(ops, g))
    shares = (["copy_to", "coarse", "copy_back"]
              + [f"L{l} {h}" for l in range(1, L + 1)
                 for h in ("down", "up")])
    return pieces, shares


def time_pieces(fns: dict, device, graphs: bool) -> dict:
    """name -> (eager ms, graph ms or None): medians of REPS samples."""
    eager = {k: float(np.median(time_samples(fn, REPS, device)))
             for k, fn in fns.items()}
    graph = ({k: float(np.median(v)) for k, v in graph_samples(fns).items()}
             if graphs and device.type == "cuda" else {})
    return {k: (eager[k], graph.get(k)) for k in fns}


def device_solves(sim, device) -> tuple:
    """The driver's solve of the device-operator system three ways:
    records, and the eager solution (float64 numpy)."""
    from coulomb_gmg_tpu_torch.solver.cg import to_host
    from coulomb_gmg_tpu_torch.solver.device_gmg import solve_refined_device
    g, cfg = sim.gmg, sim.cfg
    recs, xs = [], []
    g.release()
    for name, fused in (("eager", False), ("stepped_cold", True),
                        ("stepped_hot", True)):
        g.fused = fused
        reads = to_host.reads
        (x, k, res0, res, passes), s = wall_s(
            lambda: solve_refined_device(g, None, rtol=cfg.cg_rtol,
                                         maxiter=cfg.cg_max_iters), device)
        recs.append({"solve": name, "s": s, "cg": k, "passes": passes,
                     "residual_rel": res / res0, "reads": to_host.reads
                     - reads})
        xs.append(x.cpu().numpy())
    if not all(np.array_equal(xs[0], x) for x in xs[1:]) or len(
            {(r["cg"], tuple(r["passes"])) for r in recs}) != 1:
        raise AssertionError("profile_pieces: the eager and stepped solves "
                             "differ")
    return recs, xs[0]


def host_solves(sim, device) -> tuple:
    """The host-assembled float32 ``TpuGMG``: builds and solves; records
    and the matvec operands (the system as a sliced ELL)."""
    from coulomb_gmg_tpu_torch.solver.tpu_gmg import TpuGMG
    rhs = np.asarray(sim.rhs)
    cache = {}
    build = lambda: TpuGMG(sim.gmg, sim.A, sim.forest, device,
                           dtype=torch.float32, use_dst=True,
                           host_cache=cache, fused=False)
    g, s_build = wall_s(build, device)
    _, s_rebuild = wall_s(build, device)
    recs = [{"host_solve": "build", "s": s_build},
            {"host_solve": "rebuild", "s": s_rebuild,
             "saving_s": s_build - s_rebuild}]
    xs = []
    g.solve(rhs, rtol=1e-6)                             # warm-up
    for name, fused in (("eager", False), ("stepped_cold", True),
                        ("stepped_hot", True)):
        g.fused = fused
        (x, k, res0, res), s = wall_s(lambda: g.solve(rhs, rtol=1e-6), device)
        recs.append({"host_solve": name, "s": s, "cg": k,
                     "residual_rel": res / res0})
        xs.append(x)
    if not all(torch.equal(xs[0], x) for x in xs[1:]):
        raise AssertionError("profile_pieces: TpuGMG's eager and stepped "
                             "solves differ")
    g.release()
    return recs


def matvecs(ops: dict, A, x: torch.Tensor, device) -> list:
    """The cellwise system matvec and the assembled system as an ELL of
    the same row count, sliced and padded."""
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.solver.gmg import cellwise_mv
    sl, vals = A.ell(x.numel(), torch.float32)
    pc, pv = sl.padded(vals)
    fns = {"cellwise": lambda: cellwise_mv(ops["sys"], x),
           "ell_sliced": lambda: ell_mv(sl, vals, x),
           "ell_padded": lambda: ell_mv(pc, pv, x)}
    ref = fns["cellwise"]()[:-1]
    scale = float(ref.abs().max())
    t = time_pieces(fns, device, graphs=True)
    slots = {"cellwise": None, "ell_sliced": sl.cols.numel(),
             "ell_padded": pc.numel()}
    return [{"matvec": k, "rows": x.numel(), "slots": slots[k],
             "eager_ms": t[k][0], "graph_ms": t[k][1],
             "max_rel_diff": float((fn()[:-1] - ref).abs().max()) / scale}
            for k, fn in fns.items()]


def run(n: int, cycles: int, device) -> dict:
    """Every record, and the eager solve's solution: ``{"records",
    "x_eager", "sim"}`` (``sim``: the device-operator run)."""
    name = device_name(device)
    records = []

    def emit(rec):
        rec["device"] = name
        records.append(rec)
        print(json.dumps(rec), flush=True)

    sim = system(n, cycles, device, "on")
    last = sim.results[-1]
    ops = sim.gmg.ops
    emit({"system": "device operators", "cells": last["n_cells"],
          "dofs": last["n_dofs"], "levels": len(ops["levels"]),
          "rows_by_level": [lv["inv_diag"].numel() for lv in ops["levels"]],
          "driver_cg": last["cg_iterations"],
          "driver_passes": last["cg_passes"]})
    g = sim.gmg.b64.to(sim.gmg.dtype)
    pieces, shares = vcycle_pieces(ops, g)
    # the coarse CG reads the host every iteration: no graph holds it
    t = time_pieces({k: fn for k, (_, fn) in pieces.items()}, device,
                    graphs=ops["dst"] is not None)
    for k, (lvl, _) in pieces.items():
        emit({"piece": k, "level": lvl, "eager_ms": t[k][0],
              "graph_ms": t[k][1]})
    check = {"check": "vcycle_sum", "pieces": shares}
    for i, how in enumerate(("eager", "graph")):
        if t["vcycle"][i] is not None:
            total = sum(t[k][i] for k in shares)
            check.update({f"{how}_sum_ms": total,
                          f"{how}_vcycle_ms": t["vcycle"][i],
                          f"{how}_ratio": total / t["vcycle"][i]})
    emit(check)
    recs, x_eager = device_solves(sim, device)
    for rec in recs:
        emit(rec)
    host = system(n, cycles, device, "off")
    for rec in host_solves(host, device):
        emit(rec)
    for rec in matvecs(ops, host.A, g, device):
        emit(rec)
    return {"records": records, "x_eager": x_eager, "sim": sim}


def main(argv=None) -> dict:
    """Profile and print; returns :func:`run`'s result."""
    from coulomb_gmg_tpu_torch.device import resolve
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10, help="atoms = 8 n^3")
    ap.add_argument("--cycles", type=int, default=1,
                    help="adaptive cycles run; the last one is profiled")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu on request)")
    args = ap.parse_args(argv)
    return run(args.n, args.cycles, resolve(args.device))


if __name__ == "__main__":
    main()
