"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require a CUDA card; print the nvidia-smi name and power limit;
2. build: compile the seven hand kernels (coulomb_gmg_tpu_torch/csrc) with
   nvcc, one process per source, all started together;
3. kernel vs plain PyTorch version on the card, at main-path shapes (the
   8,000-atom cycle-0 mesh: density plan, finest level operator, RHS and
   Laplace quadrature points x 8,000 atoms), with CUDA event timings, each
   kernel's bound (coulomb_gmg_tpu_torch/roofline.py, from this run's
   inputs) and, for the ELL SpMV, the time of the one PyTorch call that
   computes the same product (``torch.mv`` on a CSR tensor, cuSPARSE), a
   yardstick the port never calls.  The ELL kernel is also timed on every
   level operator (A and P) of the cycle-0 hierarchy; the dense density
   counts the (point, atom) pairs it evaluated and must give the same bits
   with its exact skip of zero terms as without it.  The ordered segment
   sum of the card CSR assembly runs on the card plan of the same mesh's
   system (fem/card_assembly.py, as the float64 route of phase 6 builds it
   at its cycle 0), matrix and load vector, and must give the plain
   version's bits (``torch.equal``);
4. main path: the 8,000-atom production run (5 adaptive cycles) through
   ``Simulation``; the published per-cycle cell counts must come out
   exactly, every cycle must reach a true float64 residual of
   1e-8 * ||b|| with the earlier CG counts, and the tile-density and ELL
   kernels must have been launched by that run; afterwards the ELL kernel
   is timed on every level operator of that run's last hierarchy;
5. the same lattice with the reference's defaults for two flags: the
   brute-force density (no locality index) and the FE-error postprocess.
   Cycle 0 must have 512,000 cells, every cycle the true residual of
   phase 4, every FE error must be finite and in (0, 0.03 sqrt(n_atoms))
   and equal the earlier runs' to rel 1e-8, the last one must agree with
   its float64 plain recomputation to rel 1e-4, and the dense-density,
   exact-gradient and ELL kernels (not the tile kernel, nor the segment
   sum) must have been launched by that run;
6. the host-assembled path at full width: the same 8,000-atom study in the
   reference's own precision (float64, card CSR assembly, the level-matrix
   GMG with the SSOR smoother and its coarse CG, the float64 list
   density), ``production_scaling_config(10, dtype="float64",
   device_operators="off")``.  The published cells must come out exactly,
   every cycle at a true float64 residual of 1e-8 * ||b||, the solution
   finite, the earlier runs' CG counts, the ELL kernel (float64 launches
   among them), the CSR assembly's segment sum, the SSOR sweep (one
   launch an application, no host SSOR) and the list density (one launch
   a cycle) launched and the tile kernel not;
   it prints the stage seconds, the SSOR applications, the coarse CG
   iterations per V-cycle and the peak device memory.  Then the list
   density on that run's lists at cycle 0 (one row a cell) and at the
   last cycle (each cell reading its cycle-0 ancestor's row), in float64
   and float32: against the plain list branch on the CPU (float64 within
   1e-14 of the largest value, float32 no farther from the float64 sums
   than twice the plain float32 branch), empty rows and the padding row
   exactly zero, the same bits on repeat, the kernel timed (operands on the card)
   beside the plain branch's one call, with its bound.  Then every level's
   card SSOR against the scipy sweep on one defect (rel 1e-13, the same
   bits on repeat), both timed beside cuSPARSE's triangular solves, with
   the sweep's bounds (bytes, and the depth of its rows' dependency
   chains).  Then the ELL layouts on the
   last cycle's float64 system (K = 51): the host build of the sliced
   layout beside the padded reference's, and the sliced kernel timed
   beside the padded kernel on the same operator and beside ``torch.mv``
   on a float64 CSR copy (cuSPARSE), each timed as CUDA graphs of
   back-to-back calls: the padded kernel must give the sliced kernel's
   values (``torch.equal``),
   and the sliced kernel must take at most 1.10x cuSPARSE's time, be at
   least 1.5x faster than the padded one and reach 60% of its bound.
   Every level's A, P and R = P^T are timed both ways too.  On no
   operator may the sliced samples all lie above the slowest padded one
   (beyond the padded spread).  Each line gives the slots, padding share
   and bytes of each layout and the bound;
7. the other two host-assembled routes at a smaller size:
   ``examples/step-16.prm`` in float32 (tile density, ``TpuGMG`` with
   ``solve_refined``) and the same file with the Jacobi preconditioner
   (``tpu_cg_solve``), cells and CG held to JAX CPU runs of the same
   configurations, the matrices of both summed on the card by the segment
   sum kernel; then the replay and read times of the stepped solve's
   graphs on the last Step16 hierarchy (its coarse CG);
8. the device-operator path in float64 at full width:
   ``production_scaling_config(10, dtype="float64", device_operators="on",
   solver_backend="tpu_cg")`` (the JAX eligibility needs ``use_tpu_cg``,
   which ``"auto"`` gives only in float32): one GMG-CG at ``cg_rtol`` per
   cycle, the float32 list density of the tpu_cg route.  The published
   cells, a true float64 residual of 1.01e-8 * ||b|| every cycle, ELL
   launches all float64 and no tile or segment-sum launch (no CSR is
   built on this route); it prints the CG counts,
   stages and peak memory;
9. several devices on the one card: 4 shards on ``cuda:0``.  First the
   8,000-atom study in float64 through the SPMD path (sharded list density
   and assembly, ``ShardedGMG``, sharded Kelly estimate): the published
   cells, the true residual of phase 8, ELL launches, and ``ShardedGMG``
   stepped as CUDA graphs (the default ``solve_fused``); it prints the CG
   counts, stages and peak memory.  Then cycle 0 of the same study in
   float32 (the tile kernel once per shard, ``ShardedGMG`` without
   iterative refinement, as in JAX): the published cells, a finite
   solution; it prints the CG count and the true float64 residual, which
   is not gated.  Then, at the cycle-0 shapes, the sharded tile density
   must be ``torch.equal`` to the single-device tile kernel and the
   sharded float32 FE error within rel 1e-6 of the single-device one,
   each a kernel launch per shard;
10. output: ``examples/step-16.prm`` in float32 with ``write_vtu`` for 2
   cycles, and the 8-atom production configuration on 2 shards of
   ``cuda:0`` for 1 cycle, into a temporary directory, parsed back: piece
   counts, ``subdomain``, cells that partition the mesh, finite fields;
   each run prints its CG counts and true residuals;
11. several processes: two worker processes of
   ``coulomb_gmg_tpu_torch.parallel.multihost``, both on ``cuda:0``, joined
   by a gloo group (CUDA tensors staged through host memory), 2 shards
   each, D = 4.  Each runs the sharded Jacobi-CG on a 12^3 Poisson matrix
   and builds the 8,000-atom float64 host-assembled study to cycle 2
   (``production_scaling_config(10, dtype="float64",
   n_adaptive_cycles=3)``, 523,592 cells), whose system both then solve by
   ``ShardedGMG`` across the two processes.  Both ranks must exit 0 and
   agree on every iteration count and bitwise on the checksums, rank 0's
   one-process 4-shard solves, stepped and eager, must be ``torch.equal``
   to the two-process ones (so must the all-gather imports), which run
   the stepped solves uncaptured (each rank prints the mode and the GMG
   solve's host reads), each rank's eager loops across the two processes
   must give the stepped solves' bits, counts and reads, the GMG true
   residual must be <= 1.01e-8 ||b|| and each rank must have launched the
   ELL kernel.  It prints each rank's wall, solve seconds (stepped and
   eager), CG count, halo and coarse-gather bytes per V-cycle, seconds in
   collectives and peak memory.  With two or more cards the same run is
   made with NCCL, one rank per card, where the stepped solves are CUDA
   graphs with the collectives captured ("stepped, CUDA graphs: 2
   processes (nccl)"), held to the same gates and to their eager loops;
   each rank prints the capture and instantiate seconds, warm-up launches
   and the ms of one replay of each ``ShardedGMG`` graph.  With one card
   a line says why the NCCL run was not made;
12. fused: the 8,000-atom float32 production run once with
   ``solve_fused=False`` (the eager loops, one host read per CG iteration)
   and once with the default ``solve_fused=True`` (solver/fused.py: each
   solve a start and step CUDA graph captured once per cycle, one read of
   the solve's state per replay batch), the way phases 4 to 11 now run.
   The two runs must give the same CG count in every refinement pass and
   the same bits in every cycle's solution, the graph run must launch the
   ELL kernel as often as the eager run plus its warm-ups (one eager run
   of every graph's body a cycle, before the capture), and every graph
   solve must make at most ``k + 2`` host reads.  It prints the counts,
   warm-up launches, reads per solve, capture and instantiate seconds per
   cycle, "Solve" seconds and peak device memory of both, the size of the
   last cycle's graph memory pool, and its step's replay and read times;
13. sharded fused, run right after phase 9 on that run's last system
   (its ``ShardedGMG``, 4 shards of ``cuda:0``, float64): one solve from
   zero as the eager loops, one stepped as CUDA graphs.  They must give
   the same bits, CG count, norms and coarse iterations per V-cycle, the
   graph solve the eager ELL launches plus its warm-up's, both ``k + 1 +
   sum(kc + 1)`` host reads (k CG steps, k + 1 V-cycles of kc coarse
   iterations), a true residual <= 1.01e-8 ||b||, and the mode "stepped,
   CUDA graphs"; it prints both solves' seconds, the step-head, coarse and
   step-tail replay and read times, capture and instantiate seconds, the
   graph pool and peak memory.  Then the sharded Jacobi-CG on a 64^3
   7-point Poisson matrix at 4 shards, eager and stepped: the same bits
   and count, ``k + 2`` reads each, ELL launches eager plus warm-ups.
   Between the two, ``ShardedGMG``'s gathered float64 level 0 (K = 27) is
   timed sliced, padded and through ``torch.mv``, with the spread gate of
   phase 6's operators.  With two or more cards, then the same system and
   the Jacobi-CG with one shard on each of ``min(4, device_count)`` cards
   of this process, eager, then as CUDA graphs (one graph over all the
   cards a segment, "stepped, CUDA graphs: N shards on N cards"): the
   same bits, counts and reads both ways and as the one-card graph solve
   of as many shards, and ELL launches on every card
   (``kernels.LAUNCHES``); it prints the peer access between the cards,
   both solves' seconds, the replay ms of the step-head, coarse and
   step-tail graphs (all cards together), the capture and instantiate
   seconds.  With one card a line says it was not run;
14. bench: the port's headline benchmark, ``python -m
   coulomb_gmg_tpu_torch.bench`` with ``BENCH_N=10`` (8,000 atoms) and
   ``BENCH_RUNS=1``, configuration ``gpu``, in a process of its own.  It
   must exit 0 with a valid headline (no ``_INVALID``) on this card
   (``torch.cuda.get_device_name(0)``), the published cells and tile and
   ELL launches; it prints the headline;
15. tools: the port's studies and profilers through their ``main``;
16. topology, run right after phase 4: the cycle's mesh topology (DoF
   numbering, hanging pairs, level DoFs and cells, level topology, copy
   maps, covering map, solution transfer, face plans built and updated,
   Kelly estimate and marking; ``topology.topology_outputs``) on
   every refinement step of the 8-atom production trajectory (run here on
   the card) and of phase 4's 8,000-atom trajectory, computed once with
   the forests on the card and once on the CPU from the same inputs:
   every array must be on its device, the integer and boolean arrays
   ``torch.equal`` and the float64 ones (positions, hanging weights,
   transfer, estimate, threshold) within rel 1e-14 (max |card - CPU| /
   max |CPU|), and the card's marking must give the flags that refined
   the run's mesh.  It prints the seconds of both, the largest float
   difference and how often each step made the host wait on the card
   (``torch.cuda.set_sync_debug_mode``).  Then the 8,000-atom stage seconds of the
   parent tree and of this one, each through ``python -m
   coulomb_gmg_tpu_torch.profile_topology`` in a process of its own (the
   parent tree is ``$CHIP_SMOKE_PARENT``, else ``git archive HEAD^`` of a
   git checkout into ``build/parent_tree/<commit>``, else a line says it
   is not available); this tree's
   published cells and CG counts are held to phase 4's.

Each phase prints its seconds.  The line before the last is the kernels'
JSON record (launches summed over phases 4 to 14, phase 11's from both
workers and phase 14's from the bench's timed run, the graph solves'
warm-ups included); the last line is ``{"ok": true, "device": {...}}``.
"""

import base64
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the timing helpers of the port's kernel benchmark, so the two time alike
from coulomb_gmg_tpu_torch.bench_kernels import (  # noqa: E402
    PLAIN_REPS, graph_samples, median_ms)

ATOMS_N = 10                       # 8 * 10^3 = 8,000 atoms
REF_CELLS = [512000, 512560, 523592, 543024, 576428]   # bench.py:65-72
REF_CELLS_64K = [1728000, 1728560, 1749672, 1785904, 1849296]
# Regression anchors from the port's earlier runs on the H100 (both paths
# gave these CG counts in every run; the FE errors are phase 5's, identical
# to ten digits across runs): a kernel change that keeps the arithmetic
# must reproduce them.
EARLIER_CG = [3, 5, 7, 8, 8]
EARLIER_HOST_F64_CG = [1, 6, 7, 7, 8]       # phase 6's, in every run
EARLIER_FE = [0.8200123289, 0.8031798466, 0.7377463069, 0.6519717620,
              0.5959950238]
ROOT = os.path.dirname(os.path.abspath(__file__))
# JAX CPU runs (coulomb_gmg_tpu Simulation, x64 on, solver_backend="tpu_cg",
# smoother="mc_ssor") of examples/step-16.prm in float32: GMG with
# flag_rhs_assembly=True, 5 cycles, through the fused TpuGMG solve; Jacobi,
# 3 cycles.  The Jacobi route's CG runs past float32 resolution at the
# .prm's 1e-8 (its true residual stays near 1e-6 * |b|), so its count
# depends on rounding: it is held to +-4, the GMG route's to +-1.
STEP16_F32 = dict(cells=[4096, 5307, 7526, 10032, 17312],
                  cg=[6, 15, 15, 17, 17], slack=1)
STEP16_JACOBI = dict(cells=[4096, 5307, 7526], cg=[13, 19, 28], slack=4)
KERNELS = ("ell_spmv", "tile_density", "dense_density", "exact_gradient",
           "segment_sum", "ssor_sweep", "list_density", "matrix_norms",
           "distribute_rows")
# the kernel source file (csrc/<file>.cu) of each of KERNELS
SOURCE = dict(zip(KERNELS, KERNELS)) | {"matrix_norms": "solve_check",
                                        "distribute_rows": "solve_check"}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    return line


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from coulomb_gmg_tpu_torch import kernels
    t0 = time.time()
    files = sorted(set(SOURCE.values()))
    with ThreadPoolExecutor(len(files)) as pool:
        for f in [pool.submit(kernels.build, n) for n in files]:
            f.result()
    for name in files:
        log = kernels.BUILD_LOG.get(name, {})
        ptxas = [ln.strip() for ln in log.get("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {log.get('seconds', 0.0):.2f} s; "
              + " | ".join(ptxas), flush=True)
    print(f"[build] all: {time.time() - t0:.2f} s", flush=True)


def counters():
    from coulomb_gmg_tpu_torch.ops.density import dense_density, list_density
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient
    from coulomb_gmg_tpu_torch.ops.tile_density import tile_density
    from coulomb_gmg_tpu_torch.fem.card_assembly import segment_sum
    from coulomb_gmg_tpu_torch.ops.smoothers import ssor_sweep
    from coulomb_gmg_tpu_torch.solver.check import (distribute_rows,
                                                    matrix_norms)
    return {"ell_spmv": ell_mv, "tile_density": tile_density,
            "dense_density": dense_density, "exact_gradient": exact_gradient,
            "segment_sum": segment_sum, "ssor_sweep": ssor_sweep,
            "list_density": list_density, "matrix_norms": matrix_norms,
            "distribute_rows": distribute_rows}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
    counters()["ell_spmv"].launches_f64 = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def bound_text(b, ms):
    return (f"bound {b['bound_ms']:.4g} ms by {b['bound_by']} ({b['ops']:.3e}"
            f" FP32 ops, {b['bytes']:.3e} bytes), {100 * b['bound_ms'] / ms:.1f}"
            f"% of it")


def ell_as_csr(cols, vals):
    """The ELL operator as a CSR tensor, padding slots (value 0) dropped:
    the input of the cuSPARSE yardstick, built once outside any timing."""
    import warnings
    import torch
    keep = (vals != 0).T                       # (n, K): row-major slots
    crow = torch.zeros(cols.shape[1] + 1, dtype=torch.int32,
                       device=cols.device)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "CSR support is in beta"
        return torch.sparse_csr_tensor(
            crow, cols.T[keep].contiguous(), vals.T[keep].contiguous(),
            size=(cols.shape[1], cols.shape[1]), check_invariants=False)


def ell_layouts(tag, op, x, lib=False):
    """One operator built from a CSR, ``op`` its sliced pair, against its
    padded pair (``Slices.padded``, the layout ``ELL.device`` gives) on
    ``x``: the two kernels must give equal values (``torch.equal``) and the
    sliced one the plain version's to rel 1e-12 (float64) or 1e-6, and the
    sliced samples must not all lie above the slowest padded one (beyond
    the padded spread).  ``lib``: also ``torch.mv`` on a CSR copy
    (cuSPARSE) and the plain version.  Prints one line with the slots
    and bytes of each layout, the samples' medians and spreads, and the
    bound; returns the medians (ms) and the bound.  Times are :func:`graph_samples`, device time only:
    a small level's kernel is shorter than its wrapper's host time."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import ell
    sl, vals = op
    pc, pv = sl.padded(vals)
    y = ell.ell_mv_cuda(sl, vals, x)
    if not torch.equal(y, ell.ell_mv_cuda(pc, pv, x)):
        raise AssertionError(f"ell {tag}: the sliced kernel's values differ "
                             f"from the padded kernel's")
    yp = ell.ell_mv_plain(sl, vals, x)
    err = float((y - yp).abs().max())
    tol = 1e-12 if x.dtype == torch.float64 else 1e-6
    if not err <= tol * max(float(yp.abs().max()), 1e-300):
        raise AssertionError(f"ell {tag}: max err {err:.3e} vs plain")
    fns = {"sliced": lambda: ell.ell_mv_cuda(sl, vals, x),
           "padded": lambda: ell.ell_mv_cuda(pc, pv, x)}
    if lib:
        csr = ell_as_csr(pc, pv)
        err_lib = float((torch.mv(csr, x) - yp).abs().max())
        if not err_lib <= tol * float(yp.abs().max()):
            raise AssertionError(f"ell {tag}: torch.mv on the CSR copy: max "
                                 f"err {err_lib:.3e}")
        fns["torch.mv"] = lambda: torch.mv(csr, x)
        fns["plain"] = lambda: ell.ell_mv_plain(sl, vals, x)
    t = graph_samples(fns)
    ms = {k: float(np.median(v)) for k, v in t.items()}
    slower = min(t["sliced"]) > max(t["padded"])
    b = roofline.ell_spmv(sl, vals, x)
    K, n = pc.shape
    es = 4 + vals.element_size()
    xy = x.numel() * x.element_size() + n * vals.element_size()
    slots = {"padded": K * n, "sliced": sl.cols.numel()}
    print(f"[ell {tag}] K={K} rows={n} nnz={b['terms']} {x.dtype}; slots "
          + ", ".join(f"{k} {v} ({100 * (1 - b['terms'] / max(v, 1)):.1f}% "
                      f"padding, {v * es + xy:.4g} B)"
                      for k, v in slots.items())
          + "; ms median [min-max]: "
          + ", ".join(f"{k} {ms[k]:.4f} [{min(v):.4f}-{max(v):.4f}]"
                      for k, v in t.items())
          + f"; padded / sliced {ms['padded'] / ms['sliced']:.3f}"
          + (f"; sliced / torch.mv {ms['sliced'] / ms['torch.mv']:.3f}"
             if lib else "")
          + f"; max|err| {err:.3e}; {bound_text(b, ms['sliced'])}; "
          + ("SLOWER than padded beyond the spread" if slower
             else "within or below the padded spread"), flush=True)
    if slower:
        raise AssertionError(f"ell {tag}: sliced {min(t['sliced']):.4f}-"
                             f"{max(t['sliced']):.4f} ms is beyond the "
                             f"padded samples' spread {min(t['padded']):.4f}-"
                             f"{max(t['padded']):.4f}")
    return {**ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "err": err}


def ell_csr_levels(gmg, tag):
    """:func:`ell_layouts` on every level's A, P and R = P^T of a level GMG
    built from CSRs (float64, random x): the operators of its V-cycle."""
    import torch
    rng = np.random.default_rng(3)
    for lvl, (A, P) in enumerate(zip(gmg.matrices, gmg.prolongations)):
        for key, M, tr in (("A", A, False), ("P", P, False), ("R", P, True)):
            if M is None:
                continue
            x = torch.from_numpy(rng.standard_normal(
                M.n_rows if tr else M.n_cols)).to(M.data.device)
            ell_layouts(f"{tag} level {lvl} {key}", M.ell(transpose=tr), x)


def ell_levels(levels, tag):
    """Time the ELL kernel on every level's A and P (float32, random x),
    each checked against its plain version; one line per operator."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import ell
    rng = np.random.default_rng(2)
    for lvl, lv in enumerate(levels):
        for key in ("A", "P"):
            if lv.get(key) is None:
                continue
            cols, vals = lv[key]
            x = torch.from_numpy(rng.standard_normal(
                int(cols.max()) + 1)).to(cols.device, torch.float32)
            yk = ell.ell_mv_cuda(cols, vals, x)
            yp = ell.ell_mv_plain(cols, vals, x)
            err = float((yk - yp).abs().max())
            if not err <= 1e-6 * max(float(yp.abs().max()), 1e-30):
                raise AssertionError(f"ell_spmv {tag} level {lvl} {key}: "
                                     f"max err {err:.3e}")
            ms = median_ms(lambda: ell.ell_mv_cuda(cols, vals, x))
            b = roofline.ell_spmv(cols, vals, x)
            print(f"[ell {tag}] level {lvl} {key}: K={cols.shape[0]} rows="
                  f"{cols.shape[1]} kernel {ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({100 * b['bound_ms'] / ms:.1f}%)",
                  flush=True)


def phase_kernels():
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.ops import density as dd, ell, gradient as gr
    from coulomb_gmg_tpu_torch.ops import tile_density as td
    from coulomb_gmg_tpu_torch.solver.device_gmg import StencilGMG

    dev = torch.device("cuda")
    cfg = production_scaling_config(ATOMS_N, dtype="float32")
    atoms = nacl_lattice(ATOMS_N)
    sim = Simulation(cfg, atoms=atoms, device=dev,
                     pcout=Pcout(enabled=False))
    f = sim.make_initial_mesh()
    n_q = len(sim.tab_rhs.points)
    cut = cfg.nonzero_radius * cfg.r_c
    plan = td.build_tile_plan(f, n_q, atoms.positions, atoms.charges, cut,
                              n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, sim.tab_rhs.points, plan, cfg.r_c, cut,
                                dev)
    kw["n_out"] = f.n_cells + 1
    rho_k = td.tile_density_cuda(*args, **kw)
    rho_p = td.tile_density_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(rho_k != 0, rho_p != 0):
        raise AssertionError("tile_density: nonzero sets differ")
    scale = float(rho_p.abs().max())
    err_td = float((rho_k - rho_p).abs().max())
    if not err_td <= 1e-5 * scale:
        raise AssertionError(f"tile_density: max err {err_td:.3e} > "
                             f"1e-5 * {scale:.3e}")
    ms_td = median_ms(lambda: td.tile_density_cuda(*args, **kw))
    ms_td_plain = median_ms(lambda: td.tile_density_plain(*args, **kw))
    b_td = roofline.tile_density(args, kw, rho_k)
    print(f"[kernel] tile_density: {len(plan.atile)} items of {plan.a_tile} "
          f"atoms, {plan.nb} blocks, {b_td['terms']} member terms; max|err| "
          f"{err_td:.3e} (max|rho| {scale:.3e}); kernel {ms_td:.4f} ms, plain "
          f"{ms_td_plain:.3f} ms; {bound_text(b_td, ms_td)}", flush=True)

    # ELL SpMV on the finest level operator of the same cycle-0 run
    sim.forest = f
    sim.setup()
    g = StencilGMG(f, f.dofs_of(1), sim.constraints, dev, torch.float32)
    cols, vals = g.ops["levels"][-1]["A"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        cols.shape[1])).to(dev)
    errs = {}
    for dt, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        v, xx = vals.to(dt), x.to(dt)
        yk = ell.ell_mv_cuda(cols, v, xx)
        yp = ell.ell_mv_plain(cols, v, xx)
        ymax = float(yp.abs().max())
        errs[dt] = float((yk - yp).abs().max())
        if not errs[dt] <= tol * ymax:
            raise AssertionError(f"ell_spmv {dt}: max err {errs[dt]:.3e} > "
                                 f"{tol} * {ymax:.3e}")
    x32 = x.float()
    csr = ell_as_csr(cols, vals)
    y_lib = torch.mv(csr, x32)
    y_ref = ell.ell_mv_plain(cols, vals, x32)
    err_lib = float((y_lib - y_ref).abs().max())
    if not err_lib <= 1e-6 * float(y_ref.abs().max()):
        raise AssertionError(f"torch.mv on the CSR copy: max err {err_lib:.3e}")
    ms_ell = median_ms(lambda: ell.ell_mv_cuda(cols, vals, x32))
    ms_ell_plain = median_ms(lambda: ell.ell_mv_plain(cols, vals, x32))
    ms_ell_lib = median_ms(lambda: torch.mv(csr, x32))
    b_ell = roofline.ell_spmv(cols, vals, x32)
    print(f"[kernel] ell_spmv: K={cols.shape[0]} rows={cols.shape[1]}; max|err|"
          f" f32 {errs[torch.float32]:.3e} f64 {errs[torch.float64]:.3e}; "
          f"kernel {ms_ell:.4f} ms, plain {ms_ell_plain:.4f} ms, torch.mv "
          f"CSR ({csr.values().numel()} nonzeros) {ms_ell_lib:.4f} ms; "
          f"{bound_text(b_ell, ms_ell)}", flush=True)
    ell_levels(g.ops["levels"], "cycle 0")

    # brute-force density at the cycle-0 RHS points x all 8,000 atoms
    args, kw = dd.density_operands(f, sim.tab_rhs.points, atoms.positions,
                                   atoms.charges, cfg.r_c, dev)
    kw["n_out"] = f.n_cells + 1
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    rb_k = dd.dense_density_cuda(*args, **kw, pairs=pairs)
    rb_all = dd.dense_density_cuda(*args, **kw, skip_r2=float("inf"))
    rb_p = dd.dense_density_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(rb_k, rb_all):
        raise AssertionError("dense_density: the skip of zero terms changed "
                             "the output")
    scale = float(rb_p.abs().max())
    err_dd = float((rb_k - rb_p).abs().max())
    tail = float((rb_k - rho_k).abs().max())
    if not err_dd <= 1e-5 * scale:
        raise AssertionError(f"dense_density: max err {err_dd:.3e} > "
                             f"1e-5 * {scale:.3e}")
    if rb_k[f.n_cells:].any():
        raise AssertionError("dense_density: padding row not zero")
    if not tail <= 1e-2 * scale:
        raise AssertionError(f"dense vs tile density: {tail:.3e} > "
                             f"1e-2 * {scale:.3e}")
    ms_dd = median_ms(lambda: dd.dense_density_cuda(*args, **kw))
    ms_dd_plain = median_ms(lambda: dd.dense_density_plain(*args, **kw),
                            PLAIN_REPS)
    b_dd = roofline.dense_density(args, kw, rb_k)
    print(f"[kernel] dense_density: {f.n_cells} cells x {n_q} points x "
          f"{atoms.n} atoms = {b_dd['pairs']} pairs, {b_dd['terms']} with a "
          f"nonzero exp, {int(pairs)} evaluated by the kernel (ZERO_EXP "
          f"{dd.ZERO_EXP}); cull on == cull off; "
          f"max|err| {err_dd:.3e} (max|rho| {scale:.3e}); "
          f"max|dense - tile| {tail:.3e} (the tail past the cutoff); kernel "
          f"{ms_dd:.3f} ms, plain {ms_dd_plain:.3f} ms ({PLAIN_REPS} reps); "
          f"{bound_text(b_dd, ms_dd)}", flush=True)

    # exact gradient at the cycle-0 Laplace (FE-error) points x 8,000 atoms
    pref = torch.from_numpy(sim.tab_lap.points).to(dev, torch.float32)
    lo = torch.from_numpy(f.cell_lower()).to(dev, torch.float32)
    hh = torch.from_numpy(f.cell_h()).to(dev, torch.float32)
    pts = (lo[:, None, :] + hh[:, None, None] * pref).reshape(-1, 3)
    A32 = dd.pack_atoms(atoms.positions, atoms.charges, dev)
    g_k = gr.exact_gradient_cuda(pts, A32, cfg.r_c)
    g_p = gr.exact_gradient_plain(pts, A32, cfg.r_c)
    torch.cuda.synchronize()
    gmax = float(g_p.abs().max())
    err_gr = float((g_k - g_p).abs().max())
    sub = torch.from_numpy(np.random.default_rng(1).choice(
        len(pts), 1 << 16, replace=False)).to(dev)
    g64 = gr.exact_gradient_plain(pts[sub].double(), A32.double(), cfg.r_c)
    err64_k = float((g_k[sub].double() - g64).abs().max())
    err64_p = float((g_p[sub].double() - g64).abs().max())
    if not (np.isfinite(err_gr) and err_gr <= 1e-4 * gmax):
        raise AssertionError(f"exact_gradient: max err {err_gr:.3e} > "
                             f"1e-4 * {gmax:.3e}")
    ms_gr = median_ms(lambda: gr.exact_gradient_cuda(pts, A32, cfg.r_c))
    ms_gr_plain = median_ms(
        lambda: gr.exact_gradient_plain(pts, A32, cfg.r_c), PLAIN_REPS)
    b_gr = roofline.exact_gradient(pts, A32, gr.far_r2(cfg.r_c))
    print(f"[kernel] exact_gradient: {len(pts)} points x {atoms.n} atoms, "
          f"{b_gr['near']} pairs nearer than {gr.FAR} r_c; max|err| "
          f"{err_gr:.3e} (max|grad| {gmax:.3e}); vs float64 on {len(sub)} "
          f"points: kernel {err64_k:.3e}, plain f32 {err64_p:.3e}; kernel "
          f"{ms_gr:.3f} ms, plain {ms_gr_plain:.3f} ms ({PLAIN_REPS} reps); "
          f"{bound_text(b_gr, ms_gr)}", flush=True)

    ss = segment_sums(sim, f)

    def row(err, ms, plain, b, lib=None):
        return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=lib)
    return {
        "tile_density": row(err_td, ms_td, ms_td_plain, b_td),
        "ell_spmv": row(errs[torch.float32], ms_ell, ms_ell_plain, b_ell,
                        ms_ell_lib),
        "dense_density": row(err_dd, ms_dd, ms_dd_plain, b_dd),
        "exact_gradient": row(err_gr, ms_gr, ms_gr_plain, b_gr),
        "segment_sum": row(0.0, ss["ms"], ss["plain_ms"], ss["bound"]),
    }


def segment_sums(sim, f):
    """The card CSR assembly's segment sum on the system of ``f`` (phase
    3's 8,000-atom cycle-0 mesh, ``sim``'s constraints): the card plan and
    float64 element values as the float64 route builds them, the matrix
    and the load vector each equal to the plain version's bits; the
    matrix's sum timed beside the plain version's."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.fem import card_assembly as ca
    from coulomb_gmg_tpu_torch.fem.integrals import rhs_cells
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = ca.plan(f.dofs_of(1).cell2dof, ca.card_constraints(sim.constraints,
                                                           dev), rhs=True)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    high = torch.cuda.max_memory_allocated() - base
    h = torch.from_numpy(f.cell_h()).to(dev)
    k = ca.cell_matrices(sim.tab_lap, h)
    rho = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (f.n_cells, len(sim.tab_rhs.points)))).to(dev)
    fc = rhs_cells(sim.tab_rhs, h, rho).reshape(-1)
    ex = p.ex
    dvals = torch.rand(len(ex.dof), dtype=torch.float64, device=dev)
    mat = (p.seg, p.src, k.kvals, k.scale, p.nb)
    load = (p.rhs_seg, p.rhs_src, fc, None, 1)
    y = ca.segment_sum(*mat, ex=ex)
    if not torch.equal(y, ca.segment_sum_plain(*mat, ex=ex)):
        raise AssertionError("segment_sum: the matrix differs from the plain "
                             "version's bits")
    yb = ca.segment_sum(*load, dvals=dvals)
    if not torch.equal(yb, ca.segment_sum_plain(*load, dvals=dvals)):
        raise AssertionError("segment_sum: the load vector differs from the "
                             "plain version's bits")
    ms = median_ms(lambda: ca.segment_sum(*mat, ex=ex))
    plain_ms = median_ms(lambda: ca.segment_sum_plain(*mat, ex=ex),
                         PLAIN_REPS)
    b = roofline.segment_sum(p.seg, p.src, y)
    print(f"[kernel] segment_sum: the 8,000-atom cycle-0 float64 system, "
          f"{p.pattern.nnz} slots, {b['terms']} entries ({len(ex.dof)} of "
          f"the constraint expansion, {len(ex.dirty_idx)} dirty cells); plan "
          f"{plan_s:.3f} s, {high} B above the live bytes; matrix and load "
          f"equal to the plain version's bits; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms ({PLAIN_REPS} reps); {bound_text(b, ms)}",
          flush=True)
    p.release()
    return {"ms": ms, "plain_ms": plain_ms, "bound": b}


def record_cycles(sim):
    """Keep (forest, solution, flags) of every cycle of ``sim``'s run, as
    its estimate leaves them (the inputs of the next refinement)."""
    rec = []
    orig = sim.estimate_and_mark

    def spy():
        orig()
        rec.append((sim.forest, np.array(sim.solution), np.array(sim.flags)))

    sim.estimate_and_mark = spy
    return rec


def phase_main_path():
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation

    cfg = production_scaling_config(ATOMS_N, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(ATOMS_N), device="cuda",
                     pcout=Pcout(enabled=False))
    traj = record_cycles(sim)
    reset_counts()
    t0 = time.time()
    res = sim.run()
    wall = time.time() - t0
    launches = read_counts()
    for r in res:
        st = " ".join(f"{k.split(',')[0].replace(' ', '_')}={v:.2f}"
                      for k, v in r["stages"].items())
        print(f"[cycle {r['cycle']}] cells {r['n_cells']} dofs {r['n_dofs']} "
              f"cg {r['cg_iterations']} {r['cg_passes']} residual "
              f"{r['residual']:.3e} (|b| {r['l2_rhs']:.6e}) s: {st}",
              flush=True)
    print(f"[main] wall {wall:.2f} s; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    cells = [r["n_cells"] for r in res]
    if cells != REF_CELLS:
        raise AssertionError(f"cells {cells} != published {REF_CELLS}")
    cg = [r["cg_iterations"] for r in res]
    if cg != EARLIER_CG:
        raise AssertionError(f"CG counts {cg} != earlier runs' {EARLIER_CG}")
    for r in res:
        if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
            raise AssertionError(f"cycle {r['cycle']}: residual "
                                 f"{r['residual']:.3e} > 1.01e-8 * |b|")
        if not 1 <= r["cg_iterations"] <= 20:
            raise AssertionError(f"cycle {r['cycle']}: CG "
                                 f"{r['cg_iterations']} outside [1, 20]")
    if not np.isfinite(sim.solution).all():
        raise AssertionError("non-finite solution")
    for name in ("ell_spmv", "tile_density"):
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
    ell_levels(sim.gmg.ops["levels"], f"cycle {res[-1]['cycle']}")
    return launches, traj


TOPOLOGY_RTOL = 1e-14      # float64 arrays, card against CPU


def topology_both_ways(tag, traj):
    """The moved topology functions on every refinement step of ``traj``
    ((forest, solution, flags) per cycle), on the card and on the CPU from
    the same inputs: integer and boolean arrays ``torch.equal``, float64
    ones within ``TOPOLOGY_RTOL``, and the card's marking must give the
    run's flags."""
    import torch
    from coulomb_gmg_tpu_torch.topology import topology_outputs
    card_s = cpu_s = 0.0
    n = 0
    worst = 0.0
    waits = []
    for (old, u_old, _), (new, u_new, flags) in zip(traj, traj[1:]):
        t0 = time.time()
        got = topology_outputs(old.on("cuda"), new.on("cuda"), u_old, u_new)
        torch.cuda.synchronize()
        card_s += time.time() - t0
        waits.append(host_waits(lambda: topology_outputs(
            old.on("cuda"), new.on("cuda"), u_old, u_new)))
        t0 = time.time()
        cpu = topology_outputs(old.on("cpu"), new.on("cpu"), u_old, u_new)
        cpu_s += time.time() - t0
        if list(got) != list(cpu):
            raise AssertionError(f"{tag}: the card's records differ in name")
        for name, t in got.items():
            if t.device.type != "cuda" or cpu[name].device.type != "cpu":
                raise AssertionError(f"{tag}: {name} on {t.device}")
            ref = cpu[name]
            if t.dtype != ref.dtype or t.shape != ref.shape:
                raise AssertionError(f"{tag} cells {new.n_cells}: {name} "
                                     f"{t.dtype} {tuple(t.shape)} on the "
                                     f"card, {ref.dtype} {tuple(ref.shape)}")
            if t.is_floating_point():
                rel = float((t.cpu() - ref).abs().max()
                            / ref.abs().max().clamp(min=1e-300)) \
                    if ref.numel() else 0.0
                worst = max(worst, rel)
                ok = rel <= TOPOLOGY_RTOL
            else:
                ok = torch.equal(t.cpu(), ref)
            if not ok:
                raise AssertionError(f"{tag} cells {new.n_cells}: {name} "
                                     "card != CPU")
        if not np.array_equal(got["flags"].cpu().numpy(), flags):
            raise AssertionError(f"{tag}: the card's marking is not the "
                                 "run's")
        n += len(got)
    print(f"[topology] {tag}: {len(traj) - 1} refinement steps, {n} arrays "
          f"card == CPU (float64 within rel {worst:.3e}); card "
          f"{card_s:.2f} s, CPU {cpu_s:.2f} s; host waits a step {waits}",
          flush=True)


def host_waits(fn) -> int:
    """How many times ``fn`` made the host wait on the card
    (``torch.cuda.set_sync_debug_mode`` warnings)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


PROFILE_TIMEOUT = 600


def profile_tree(tag, root):
    """``profile_topology`` at 8,000 atoms on the package in ``root``, in a
    process of its own (this tree's tool on that tree's package)."""
    tool = os.path.join(ROOT, "coulomb_gmg_tpu_torch", "profile_topology.py")
    code = ("import runpy, sys; sys.argv = ['profile_topology'] + "
            f"sys.argv[1:]; runpy.run_path({tool!r}, run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code, "--n", str(ATOMS_N)],
                       cwd=root, capture_output=True, text=True,
                       timeout=PROFILE_TIMEOUT)
    if p.returncode != 0:
        raise AssertionError(f"profile_topology ({tag}) exited "
                             f"{p.returncode}:\n{p.stdout[-3000:]}\n"
                             f"{p.stderr[-3000:]}")
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    for c in rec["cycles"]:
        st = " ".join(f"{k.split(',')[0].replace(' ', '_')}={v['s']:.3f}"
                      for k, v in c["stages"].items())
        print(f"[topology] {tag} cycle {c['cycle']}: cells {c['n_cells']} "
              f"cg {c['cg']} s: {st}", flush=True)
    print(f"[topology] {tag}: wall {rec['wall_s']:.2f} s; host "
          f"{rec['host']['cpu']!r}, {rec['host']['cpu_count']} CPUs, "
          f"{rec['host']['torch_threads']} torch threads", flush=True)
    return rec


def parent_tree():
    """A directory holding the parent commit's package, or None.

    ``$CHIP_SMOKE_PARENT`` if set; else ``git archive`` of ``HEAD^`` into
    ``build/parent_tree/<its commit>``, extracted once per parent commit
    (into a temporary directory renamed when complete, so a failed
    extraction leaves nothing behind); None without a git checkout that
    holds the parent (no ``.git``, a shallow clone of depth 1)."""
    given = os.environ.get("CHIP_SMOKE_PARENT")
    if given:
        return given
    try:
        rev = subprocess.run(["git", "-C", ROOT, "rev-parse", "--verify",
                              "-q", "HEAD^"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    top = os.path.join(ROOT, "build", "parent_tree")
    dest = os.path.join(top, rev)
    if os.path.isdir(dest):
        return dest
    os.makedirs(top, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".extract-", dir=top)
    try:
        arc = subprocess.run(["git", "-C", ROOT, "archive", rev],
                             capture_output=True, check=True, timeout=120)
        subprocess.run(["tar", "-x", "-C", tmp], input=arc.stdout,
                       check=True, timeout=120)
        os.rename(tmp, dest)
        return dest
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)


def phase_topology(traj8k):
    """Phase 16 (see the module docstring) on phase 4's cycles ``traj8k``,
    which it empties."""
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation

    sim = Simulation(production_scaling_config(1, dtype="float32"),
                     atoms=nacl_lattice(1), device="cuda",
                     pcout=Pcout(enabled=False))
    traj = record_cycles(sim)
    sim.run()
    del sim
    topology_both_ways("8 atoms", traj)
    topology_both_ways("8,000 atoms", traj8k)
    traj8k.clear()
    gc.collect()
    torch.cuda.empty_cache()
    parent = parent_tree()
    if parent is None:
        print("[topology] parent tree: not available (no git checkout "
              "holding HEAD^ and no CHIP_SMOKE_PARENT)", flush=True)
    else:
        print(f"[topology] parent tree: {parent}", flush=True)
        profile_tree("parent", parent)
    this = profile_tree("this tree", ROOT)
    cells = [c["n_cells"] for c in this["cycles"]]
    cg = [c["cg"] for c in this["cycles"]]
    if cells != REF_CELLS or cg != EARLIER_CG:
        raise AssertionError(f"profile_topology: cells {cells}, CG {cg}")


def phase_bruteforce_fe():
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.postprocess.energy import energy_norm_error

    cfg = production_scaling_config(ATOMS_N, dtype="float32",
                                    flag_rhs_assembly=False,
                                    flag_postprocess_error=True)
    atoms = nacl_lattice(ATOMS_N)
    sim = Simulation(cfg, atoms=atoms, device="cuda",
                     pcout=Pcout(enabled=False))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = sim.run()
    wall = time.time() - t0
    launches = read_counts()
    for r, ref in zip(res, REF_CELLS):
        st = " ".join(f"{k.split(',')[0].replace(' ', '_')}={v:.2f}"
                      for k, v in r["stages"].items())
        print(f"[brute+fe cycle {r['cycle']}] cells {r['n_cells']} "
              f"(published, locality cut: {ref}) cg {r['cg_iterations']} "
              f"{r['cg_passes']} residual {r['residual']:.3e} (|b| "
              f"{r['l2_rhs']:.6e}) fe_error {r['energy_norm_error']:.9e} "
              f"s: {st}", flush=True)
    t1 = time.time()
    fe64 = energy_norm_error(sim.forest, sim.tab_lap, sim.solution,
                             atoms.positions, atoms.charges, cfg.r_c, "cuda",
                             dtype=torch.float64)
    fe32 = res[-1]["energy_norm_error"]
    rel = abs(fe32 - fe64) / fe64
    print(f"[brute+fe] wall {wall:.2f} s; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last "
          f"FE error {fe32:.9e} vs float64 plain {fe64:.9e} (rel {rel:.2e}, "
          f"{time.time() - t1:.2f} s)", flush=True)
    if res[0]["n_cells"] != REF_CELLS[0]:
        raise AssertionError(f"cycle 0 has {res[0]['n_cells']} cells")
    cg = [r["cg_iterations"] for r in res]
    fe_rel = max(abs(r["energy_norm_error"] / e - 1)
                 for r, e in zip(res, EARLIER_FE))
    print(f"[brute+fe] CG {cg} (earlier {EARLIER_CG}); FE errors vs the "
          f"earlier runs': max rel {fe_rel:.2e}", flush=True)
    if cg != EARLIER_CG or len(res) != len(EARLIER_FE) or not fe_rel <= 1e-8:
        raise AssertionError("CG counts or FE errors differ from the earlier "
                             "runs'")
    bound = 0.03 * atoms.n ** 0.5
    for r in res:
        if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
            raise AssertionError(f"cycle {r['cycle']}: residual "
                                 f"{r['residual']:.3e} > 1.01e-8 * |b|")
        if not 1 <= r["cg_iterations"] <= 20:
            raise AssertionError(f"cycle {r['cycle']}: CG "
                                 f"{r['cg_iterations']} outside [1, 20]")
        fe = r["energy_norm_error"]
        if not (np.isfinite(fe) and 0.0 < fe < bound):
            raise AssertionError(f"cycle {r['cycle']}: FE error {fe} not in "
                                 f"(0, {bound:.3f})")
    if not rel <= 1e-4:
        raise AssertionError(f"FE error {fe32:.9e} vs float64 {fe64:.9e}: "
                             f"rel {rel:.2e} > 1e-4")
    want = {"dense_density": launches["dense_density"] == 5,
            "exact_gradient": launches["exact_gradient"] >= 5,
            "ell_spmv": launches["ell_spmv"] > 0,
            "tile_density": launches["tile_density"] == 0,
            "segment_sum": launches["segment_sum"] == 0}
    bad = [k for k, ok in want.items() if not ok]
    if bad:
        raise AssertionError(f"launch counts {launches}: wrong for {bad}")
    return launches


def stage_text(r):
    return " ".join(f"{k.split(',')[0].replace(' ', '_')}={v:.2f}"
                    for k, v in r["stages"].items())


def phase_host_f64():
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.ops import ell
    from coulomb_gmg_tpu_torch.ops.smoothers import CardSSOR
    from coulomb_gmg_tpu_torch.utils.timer import RUNS

    cfg = production_scaling_config(ATOMS_N, dtype="float64",
                                    device_operators="off")
    sim = Simulation(cfg, atoms=nacl_lattice(ATOMS_N), device="cuda",
                     pcout=Pcout(enabled=False))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = sim.run()
    wall = time.time() - t0
    launches = read_counts()
    f64 = ell.ell_mv.launches_f64
    for r in res:
        cc = r["coarse_cg"] or []
        print(f"[host f64 cycle {r['cycle']}] cells {r['n_cells']} dofs "
              f"{r['n_dofs']} levels {len(r['dofs_by_level'])} cg "
              f"{r['cg_iterations']} residual {r['residual']:.3e} (|b| "
              f"{r['l2_rhs']:.6e}) coarse CG {len(cc)} V-cycles, "
              f"iterations {cc}; s: "
              f"{stage_text(r)}", flush=True)
    ssor = {id(e[3].precond): e[3].precond for e in sim._gmg_cache.values()
            if e[3] is not None and isinstance(e[3].precond, CardSSOR)}
    spans, solve_counts = RUNS[-1]["spans"], RUNS[-1]["counters"]["Solve"]
    calls = solve_counts.get("ssor_card_calls", 0)
    host_s = spans.get("smoother.ssor", {}).get("total_s", 0.0)
    coarse_s = spans["solve.coarse"]["total_s"]
    reads_s = solve_counts.get("host_read_ns", 0) / 1e9
    peak = torch.cuda.max_memory_allocated() / 2**30
    dens_row = list_densities(sim, "host f64")
    ssor_row = ssor_levels(ssor.values(), "host f64")
    check_rows = [solve_checks(sim, "host f64 8k last cycle")]
    sys_ell = host_f64_system(sim)
    ell_csr_levels(sim.gmg, "host f64")
    cg = [r["cg_iterations"] for r in res]
    print(f"[host f64] wall {wall:.2f} s; CG {cg} (earlier "
          f"{EARLIER_HOST_F64_CG}); launches {launches} "
          f"(ELL float64 {f64}); SSOR on the card: {calls} applications "
          f"on {len(ssor)} levels (each level's card time an application "
          f"above), {host_s:.3f} s of host launch time; coarse CG "
          f"{coarse_s:.2f} s; Solve's host reads "
          f"{solve_counts.get('host_reads', 0)} ({reads_s:.2f} s, waits "
          f"included); peak device memory {peak:.2f} GiB over the run, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with the "
          f"ELL checks after it", flush=True)
    cells = [r["n_cells"] for r in res]
    if cells != REF_CELLS:
        raise AssertionError(f"host f64: cells {cells} != {REF_CELLS}")
    if cg != EARLIER_HOST_F64_CG:
        raise AssertionError(f"host f64: CG {cg} != earlier runs' "
                             f"{EARLIER_HOST_F64_CG}")
    for r in res:
        if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
            raise AssertionError(f"host f64 cycle {r['cycle']}: residual "
                                 f"{r['residual']:.3e} > 1.01e-8 * |b|")
    if not np.isfinite(sim.solution).all():
        raise AssertionError("host f64: non-finite solution")
    if not (launches["ell_spmv"] > 0 and f64 > 0
            and launches["tile_density"] == 0
            and launches["segment_sum"] > 0
            and launches["ssor_sweep"] == calls > 0
            and launches["list_density"] == len(res)
            and launches["matrix_norms"] == len(res)
            and launches["distribute_rows"] == len(res)
            and "smoother.ssor_host" not in spans):
        raise AssertionError(f"host f64: launch counts {launches}, float64 "
                             f"ELL {f64}, card SSOR applications {calls}, "
                             f"host SSOR spans "
                             f"{spans.get('smoother.ssor_host')}")
    if not (sys_ell["sliced"] <= 1.10 * sys_ell["torch.mv"]
            and sys_ell["padded"] >= 1.5 * sys_ell["sliced"]
            and sys_ell["bound_ms"] >= 0.60 * sys_ell["sliced"]):
        raise AssertionError(f"host f64: system ELL sliced "
                             f"{sys_ell['sliced']:.4f} ms, padded "
                             f"{sys_ell['padded']:.4f}, torch.mv "
                             f"{sys_ell['torch.mv']:.4f}, bound "
                             f"{sys_ell['bound_ms']:.4f}: not within 1.10x "
                             f"of torch.mv, 1.5x faster than padded and at "
                             f"60% of the bound")
    # the 1,000-atom float64 system (the benchmark's 1k cell), last cycle
    sim1k = Simulation(production_scaling_config(5, dtype="float64"),
                       atoms=nacl_lattice(5), device="cuda",
                       pcout=Pcout(enabled=False))
    sim1k.run()
    check_rows.append(solve_checks(sim1k, "host f64 1k last cycle"))
    del sim1k
    return (launches, ssor_row, dens_row) + check_rows[0]


def solve_checks(sim, tag):
    """The Solve check (solver/check.py:card_check) on ``sim``'s last
    system, with its solution as x: on the card the same bits on repeat;
    the column and row sums of ``|a|`` and the distributed solution the
    plain versions' bits on the CPU, the Frobenius and vector norms within
    1e-13 relative, the residual within 1e-13 ||b||; each kernel timed
    with its bound, the whole check's wall time with its one read, beside
    the host numpy check that it replaced (the matrix norms, vector norms
    and ``fem/constraints.py:distribute`` on the host values).  Returns
    the rows of ``matrix_norms`` and ``distribute_rows``."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.fem.constraints import distribute
    from coulomb_gmg_tpu_torch.ops.ell import Slices
    from coulomb_gmg_tpu_torch.solver import check
    A, con, dev = sim.A, sim.constraints, sim.A.data.device
    sl, vals = system = A.ell(dtype=torch.float64)
    b = torch.from_numpy(np.asarray(sim.rhs, np.float64)).to(dev)
    x = torch.from_numpy(np.asarray(sim.solution, np.float64)).to(dev)
    got = check.card_check(b, x, con, system)
    same = all(np.array_equal(check.card_check(b, x, con, system).solution,
                              got.solution) for _ in range(3))
    cpu = (Slices(sl.off.cpu(), sl.cols.cpu(), sl.n_rows, sl.width),
           vals.cpu())
    t0 = time.perf_counter()
    plain = check.card_check(b.cpu(), x.cpu(), con, cpu)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    vec = max(abs(got.norms[k] - plain.norms[k]) / abs(plain.norms[k])
              for k in ("l1_rhs", "l2_rhs", "linf_rhs", "l1_sol", "l2_sol",
                        "linf_sol", "fro_mat"))
    mat_err = max(abs(got.norms[k] - plain.norms[k]) for k in check._MAT)
    sol_err = float(np.abs(got.solution - plain.solution).max())
    if not (same and all(got.norms[k] == plain.norms[k]
                         for k in ("l1_mat", "linf_mat"))
            and sol_err == 0.0 and vec <= 1e-13
            and abs(got.residual - plain.residual)
            <= 1e-13 * got.norms["l2_rhs"]):
        raise AssertionError(f"solve_check {tag}: card {got.norms}, "
                             f"residual {got.residual}; plain {plain.norms}, "
                             f"residual {plain.residual}; same bits on "
                             f"repeat {same}")
    out = torch.empty(4, dtype=torch.float64, device=dev)
    ms = median_ms(lambda: check.matrix_norms(sl, vals, out))
    ints, floats = check._constraint_operands(con, dev)
    sol = x.clone()
    n_con, con_nnz = len(con.rows), len(con.cols)
    dist_ms = median_ms(lambda: check.distribute_rows(ints, floats, n_con, x,
                                                      sol))
    t0 = time.perf_counter()
    check.matrix_norms(*cpu, torch.empty(4, dtype=torch.float64))
    mat_plain_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    check.distribute_rows(ints.cpu(), floats.cpu(), n_con, x.cpu(),
                          x.cpu().clone())
    dist_plain_ms = 1e3 * (time.perf_counter() - t0)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        check.card_check(b, x, con, system)
        walls.append(1e3 * (time.perf_counter() - t0))
    hx, hb, data = sim.solution, np.asarray(sim.rhs, np.float64), A.data_np()
    hosts = []
    for _ in range(3):
        t0 = time.perf_counter()
        absd = np.abs(data).astype(np.float64)
        np.bincount(A.indices, weights=absd, minlength=A.n_cols).max()
        np.add.reduceat(absd, A.indptr[:-1]).max()
        np.sqrt((absd ** 2).sum())
        for v in (hb, hx):
            np.abs(v).sum(), np.linalg.norm(v), np.abs(v).max()
        distribute(con, hx)
        hosts.append(1e3 * (time.perf_counter() - t0))
    bn = roofline.matrix_norms(sl, A.nnz)
    bd = roofline.distribute_rows(n_con, con_nnz)
    print(f"[solve_check {tag}] {A.n_rows} rows, {A.nnz} nonzeros, "
          f"{n_con} constrained rows ({con_nnz} entries): matrix_norms "
          f"{ms:.4f} ms, {bound_text(bn, ms)}; distribute_rows {dist_ms:.4f} "
          f"ms, {bound_text(bd, dist_ms)}; the whole check "
          f"{np.median(walls):.3f} ms wall (median of 10, its one read "
          f"included), the host numpy check it replaced "
          f"{np.median(hosts):.1f} ms (median of 3), the plain version on "
          f"the CPU {plain_ms:.1f} ms; same bits on repeat, the plain "
          f"version's column and row sums and solution bits, Frobenius and "
          f"vector norms within {vec:.1e}; l1/linf/fro "
          f"{got.norms['l1_mat']:.10e} "
          f"{got.norms['linf_mat']:.10e} {got.norms['fro_mat']:.10e}",
          flush=True)
    return (dict(max_abs_err=mat_err, ms=ms, plain_ms=mat_plain_ms,
                 bound_ms=bn["bound_ms"], bound_by=bn["bound_by"],
                 library_ms=None),
            dict(max_abs_err=sol_err, ms=dist_ms, plain_ms=dist_plain_ms,
                 bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                 library_ms=None))


def list_densities(sim, tag):
    """The list density kernel on the lists of ``sim``'s finished run, at
    its cycle 0 (the initial mesh, one row a cell) and its last cycle
    (``home`` carried), in float64 and float32, against the plain list
    branch on the CPU: float64 within 1e-14 of the largest value; float32
    no farther from the float64 sums than twice the plain branch's own
    float32 sums are (both round every factor and term to float32, at
    coordinates up to the box's); empty rows and the padding row exactly
    zero, the same bits on repeat; timed with its operands on the card
    beside the plain branch's one call, with its bound.  Returns the last
    cycle's float64 row."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import density as dd
    from coulomb_gmg_tpu_torch.ops.neighbors import AtomLists
    last = sim.lists
    first = AtomLists(last.ptr, last.atoms,
                      np.arange(len(last.ptr) - 1, dtype=np.int32))
    at, pts, r_c = sim.atoms, sim.tab_rhs.points, sim.cfg.r_c
    row = None
    for cyc, f, lists in (("cycle 0", sim.make_initial_mesh(), first),
                          ("last cycle", sim.forest, last)):
        counts = lists.counts
        empty = torch.from_numpy(np.append(counts == 0, True))
        dens = (f, pts, at.positions, at.charges, r_c)
        exact = None
        for dt in (torch.float64, torch.float32):
            kw = dict(lists=lists, dtype=dt, n_out=f.n_cells + 1)
            out = dd.compute_density(*dens, "cuda", **kw)
            same = all(torch.equal(dd.compute_density(*dens, "cuda", **kw),
                                   out) for _ in range(3))
            t0 = time.perf_counter()
            plain = dd.compute_density(*dens, "cpu", **kw)
            plain_ms = 1e3 * (time.perf_counter() - t0)
            out = out.cpu()
            if exact is None:
                exact = plain
            big = float(exact.abs().max())
            err = float((out.double() - exact).abs().max())
            plain_err = float((plain.double() - exact).abs().max())
            diff = float((out - plain).abs().max())
            limit = 1e-14 * big if dt == torch.float64 else 2 * plain_err
            zero = bool((out[empty] == 0).all())
            if not (err <= limit and same and zero
                    and (out[~empty] != 0).any()):
                raise AssertionError(
                    f"list_density {tag} {cyc} {dt}: max err {err:.3e} > "
                    f"{limit:.3e} (max|rho| {big:.3e}), same bits on repeat "
                    f"{same}, empty rows zero {zero}")
            args, okw = dd.list_operands(*dens, lists, "cuda", dt,
                                         n_out=f.n_cells + 1)
            ms = median_ms(lambda: dd.list_density_cuda(*args, **okw))
            b = roofline.list_density(args, okw, out)
            print(f"[list_density {tag} {cyc} {dt}] {f.n_cells} cells, "
                  f"{int((counts == 0).sum())} empty, {b['terms']} entries, "
                  f"{len(pts)} points; max|err| against float64 plain "
                  f"{err:.3e} ({err / big:.2e} of max|rho| {big:.3e}; the "
                  f"plain branch in this precision {plain_err:.3e}, kernel "
                  f"vs it {diff:.3e}); same bits on repeat; kernel "
                  f"{ms:.4f} ms, plain on the CPU {plain_ms:.1f} ms (one "
                  f"call); {bound_text(b, ms)}", flush=True)
            if dt == torch.float64:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                           library_ms=None)
    return row


def ssor_levels(ssors, tag):
    """Each card SSOR of ``ssors`` (one per smoothed level) against the
    scipy sweep on the same defect (max |d| <= 1e-13 max |y|, the same
    bits on repeat), both timed (the scipy sweep with its copies, as the
    solve paid it) beside the library's sweep (:func:`ssor_cusparse`), with
    the kernel's two bounds: bytes at the card's rate and the depth of its
    rows' dependency chains.  Returns the largest level's row."""
    import torch
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops.smoothers import HostSSOR
    rng = np.random.default_rng(6)
    rows = []
    for s in sorted(ssors, key=lambda s: s.A.n_rows):
        A = s.A
        r = torch.from_numpy(rng.standard_normal(A.n_rows)).to(
            A.data.device)
        host = HostSSOR(A, s.omega)
        y, yh = s(r), host(r)
        err = float((y - yh).abs().max())
        rel = err / float(yh.abs().max())
        if not (rel <= 1e-13 and all(torch.equal(s(r), y)
                                     for _ in range(4))):
            raise AssertionError(f"ssor_sweep {tag}: {A.n_rows} rows, rel "
                                 f"err {rel:.2e} or bits differ on repeat")
        ms = median_ms(lambda: s(r))
        plain_ms = median_ms(lambda: host(r), PLAIN_REPS)
        lib = ssor_cusparse(s)
        yl = lib(r)
        lib_rel = float((yl - yh).abs().max()) / float(yh.abs().max())
        lib_bits = all(torch.equal(lib(r), yl) for _ in range(4))
        lib_ms = median_ms(lambda: lib(r))
        b = roofline.ssor_sweep(s.indptr, s.indices, A.data, r)
        steps = sum(b["depths"])
        print(f"[ssor {tag}] {A.n_rows} rows, {A.nnz} nonzeros, chain "
              f"depths {b['depths'][0]}/{b['depths'][1]}: kernel {ms:.4f} "
              f"ms ({1e3 * ms / steps:.2f} us a step), scipy with its "
              f"copies {plain_ms:.3f} ms, cuSPARSE {lib_ms:.4f} ms (rel err "
              f"{lib_rel:.2e}, same bits on repeat {lib_bits}); max abs err "
              f"{err:.2e}, rel {rel:.2e}; {bound_text(b, ms)}", flush=True)
        rows.append(dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"], library_ms=lib_ms))
    return rows[-1]


def ssor_cusparse(s):
    """The card SSOR ``s``'s application by the library: two sparse
    triangular solves (``torch.triangular_solve`` on CSR matrices, cuSPARSE
    with its analysis each call) of ``D/omega + L`` and ``D/omega + U``
    and the residual's product (``torch.mv``), built once on the card."""
    import warnings
    import torch
    n, dev = s.A.n_rows, s.A.data.device
    crow, cols = s.indptr.long(), s.indices.long()
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   crow[1:] - crow[:-1])
    vals = torch.where(cols == rows, s.A.data / s.omega, s.A.data)

    def csr(keep, v):
        cr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        cr[1:] = torch.bincount(rows[keep], minlength=n).cumsum(0)
        return torch.sparse_csr_tensor(cr, s.indices[keep], v[keep], (n, n))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "CSR support is in beta"
        lower, upper = csr(cols <= rows, vals), csr(cols >= rows, vals)
        A = csr(cols >= 0, s.A.data)

    def apply(r):
        y1 = torch.triangular_solve(r[:, None], lower,
                                    upper=False).solution[:, 0]
        return y1 + torch.triangular_solve((r - torch.mv(A, y1))[:, None],
                                           upper, upper=True).solution[:, 0]
    return apply


def host_f64_system(sim):
    """Phase 6's last system (float64, K = 51): the host build of its
    sliced layout beside the padded reference's (``ELL.from_csr``, numpy),
    then :func:`ell_layouts` with ``torch.mv``."""
    import torch
    from coulomb_gmg_tpu_torch.ops.ell import ELL, SlicedELL
    A, dev = sim.A, sim.A.data.device
    data = A.data_np()
    builds = {"sliced": [], "padded (numpy reference)": []}
    for _ in range(3):
        for name, cls in zip(builds, (SlicedELL, ELL)):
            t0 = time.perf_counter()
            e = cls.from_csr(A.indptr, A.indices, data)
            t1 = time.perf_counter()
            e.device(dev)
            torch.cuda.synchronize()
            builds[name].append((t1 - t0, time.perf_counter() - t0))
            del e
    print("[host f64] system ELL host build (s, median of 3; with the copy "
          "to the card): " + ", ".join(
              f"{k} {np.median([b[0] for b in v]):.4f} "
              f"({np.median([b[1] for b in v]):.4f})"
              for k, v in builds.items()), flush=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.n_cols)).to(dev)
    return ell_layouts("host f64 system (last cycle)", A.ell(), x, lib=True)


def phase_routes():
    from coulomb_gmg_tpu_torch.config import load_prm
    from coulomb_gmg_tpu_torch.io.lammps import read_lammps_file
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation

    total = dict.fromkeys(KERNELS, 0)
    for tag, ref, over in (
            ("step16 f32", STEP16_F32, dict(flag_rhs_assembly=True)),
            ("step16 jacobi", STEP16_JACOBI,
             dict(preconditioner="Jacobi", n_adaptive_cycles=3))):
        cfg = load_prm(os.path.join(ROOT, "examples", "step-16.prm"),
                       dtype="float32", smoother="mc_ssor", **over)
        atoms = read_lammps_file(os.path.join(ROOT, cfg.lammps_file))
        sim = Simulation(cfg, atoms=atoms, device="cuda",
                         pcout=Pcout(enabled=False))
        reset_counts()
        t0 = time.time()
        res = sim.run()
        wall = time.time() - t0
        launches = read_counts()
        for k in KERNELS:
            total[k] += launches[k]
        cells = [r["n_cells"] for r in res]
        cg = [r["cg_iterations"] for r in res]
        rel = " ".join(f"{r['residual'] / r['l2_rhs']:.3e}" for r in res)
        print(f"[{tag}] wall {wall:.2f} s; cells {cells} (JAX "
              f"{ref['cells']}); CG {cg} (JAX {ref['cg']}); residual/|b| "
              f"{rel}; launches {launches}", flush=True)
        if cells != ref["cells"]:
            raise AssertionError(f"{tag}: cells {cells} != JAX {ref['cells']}")
        if any(abs(a - b) > ref["slack"] for a, b in zip(cg, ref["cg"])):
            raise AssertionError(f"{tag}: CG {cg} vs JAX {ref['cg']} "
                                 f"(+-{ref['slack']})")
        if not np.isfinite(sim.solution).all():
            raise AssertionError(f"{tag}: non-finite solution")
        want_tile = tag == "step16 f32"
        if launches["ell_spmv"] <= 0 or launches["segment_sum"] <= 0 \
                or (launches["tile_density"] > 0) != want_tile:
            raise AssertionError(f"{tag}: launch counts {launches}")
        if want_tile:
            for r in res:
                if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
                    raise AssertionError(f"{tag} cycle {r['cycle']}: "
                                         f"residual {r['residual']:.3e}")
            coarse_costs(sim)
    return total


def coarse_costs(sim):
    """The stepped solve's graphs on the last Step16 hierarchy (its coarse
    CG on level 0): capture seconds, and the replay and read times behind
    solver/fused.py's one coarse replay per read."""
    from coulomb_gmg_tpu_torch.solver.tpu_gmg import TpuGMG
    t0 = time.time()
    g = TpuGMG(sim.gmg, sim.A, sim.forest, "cuda", use_dst=False)
    try:
        _, k, _, _ = g.solve(sim.rhs, None, rtol=1e-6, maxiter=100)
        st = g.stepped
        seg = st.segments
        costs = replay_ms(st, ("coarse",), st.coarse.active)
        costs.update(replay_ms(st, ("step_head", "step_tail"), st.active))
        print(f"[step16 f32] stepped solve on the last hierarchy: CG {k}, "
              f"level 0 {st.coarse.x.numel() - 1} dofs, capture "
              f"{seg.capture_s:.4f} s, instantiate {seg.instantiate_s:.4f} s;"
              f" replay ms: " + ", ".join(f"{n} {v:.4f}" for n, v in
                                          costs.items())
              + f"; {time.time() - t0:.2f} s in all", flush=True)
    finally:
        g.release()


def run_study(tag, cfg, n=ATOMS_N, cells=REF_CELLS, **sim_kw):
    """One run of the 8 n^3-atom lattice (8,000 atoms by default) through
    Simulation: prints every cycle and the run's totals, checks the
    published ``cells`` and the true float64 residual; returns (sim,
    results, launches)."""
    import torch
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.ops import ell
    sim = Simulation(cfg, atoms=nacl_lattice(n), device="cuda",
                     pcout=Pcout(enabled=False), **sim_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = sim.run()
    wall = time.time() - t0
    launches = read_counts()
    f64 = ell.ell_mv.launches_f64
    for r in res:
        coarse = (f" coarse CG per V-cycle {r['coarse_cg']}"
                  if r["coarse_cg"] else "")
        print(f"[{tag} cycle {r['cycle']}] cells {r['n_cells']} dofs "
              f"{r['n_dofs']} cg {r['cg_iterations']} residual "
              f"{r['residual']:.3e} (|b| {r['l2_rhs']:.6e}){coarse} s: "
              f"{stage_text(r)}", flush=True)
    cg = [r["cg_iterations"] for r in res]
    print(f"[{tag}] wall {wall:.2f} s; CG {cg}; launches {launches} (ELL "
          f"float64 {f64}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    got = [r["n_cells"] for r in res]
    if got != cells:
        raise AssertionError(f"{tag}: cells {got} != {cells}")
    for r in res:
        if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
            raise AssertionError(f"{tag} cycle {r['cycle']}: residual "
                                 f"{r['residual']:.3e} > 1.01e-8 * |b|")
        if not 1 <= r["cg_iterations"] <= 20:
            raise AssertionError(f"{tag} cycle {r['cycle']}: CG "
                                 f"{r['cg_iterations']} outside [1, 20]")
    if not np.isfinite(sim.solution).all():
        raise AssertionError(f"{tag}: non-finite solution")
    return sim, res, launches, f64


def phase_device_f64():
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.solver.device_gmg import StencilGMG
    cfg = production_scaling_config(ATOMS_N, dtype="float64",
                                    device_operators="on",
                                    solver_backend="tpu_cg")
    sim, res, launches, f64 = run_study("device f64", cfg)
    if not (sim.device_ops and isinstance(sim.gmg, StencilGMG)
            and sim.A is None):
        raise AssertionError("device f64: not the device-operator path")
    if not (launches["ell_spmv"] > 0 and f64 == launches["ell_spmv"]
            and launches["tile_density"] == 0
            and launches["segment_sum"] == 0):
        raise AssertionError(f"device f64: launch counts {launches}, "
                             f"float64 ELL {f64}")
    return launches


def phase_multi_device():
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.ops import tile_density as td
    from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient
    from coulomb_gmg_tpu_torch.ops.q1 import element_tables
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    from coulomb_gmg_tpu_torch.postprocess.energy import energy_norm_error

    D = 4
    cfg = production_scaling_config(ATOMS_N, dtype="float64", n_devices=D)
    sim, res, launches, _ = run_study(f"spmd x{D}", cfg,
                                      spmd_devices=["cuda:0"] * D)
    mode = sim.gmg.solve_info()["mode"]
    print(f"[spmd x{D}] ShardedGMG: {mode}", flush=True)
    if sim.spmd is None or sim.spmd.D != D or sim.device_ops:
        raise AssertionError("spmd: not the SPMD path")
    if launches["ell_spmv"] <= 0:
        raise AssertionError(f"spmd: launch counts {launches}")
    if mode != f"stepped, CUDA graphs: {D} shards on cuda:0":
        raise AssertionError(f"spmd: ShardedGMG ran {mode!r}")

    # float32, cycle 0: ShardedGMG without iterative refinement, as in JAX,
    # so CG stops on its recursive residual; the true one is printed, not
    # gated.  The density is the tile kernel, one launch per shard.
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    cfg32 = production_scaling_config(ATOMS_N, dtype="float32",
                                      n_devices=D, n_adaptive_cycles=1)
    sim32 = Simulation(cfg32, atoms=nacl_lattice(ATOMS_N), device="cuda",
                       pcout=Pcout(enabled=False),
                       spmd_devices=["cuda:0"] * D)
    reset_counts()
    t0 = time.time()
    res32 = sim32.run()
    wall32 = time.time() - t0
    l32 = read_counts()
    print(f"[spmd x{D} f32] wall {wall32:.2f} s; cells "
          f"{res32[0]['n_cells']}; s: {stage_text(res32[0])}; launches "
          f"{l32}", flush=True)
    print_residuals(f"spmd x{D} f32", res32)
    if not (sim32.dtype == torch.float32 and sim32.spmd is not None
            and res32[0]["n_cells"] == REF_CELLS[0]
            and l32["tile_density"] == D and l32["ell_spmv"] > 0
            and np.isfinite(sim32.solution).all()):
        raise AssertionError(f"spmd f32: cells {res32[0]['n_cells']}, "
                             f"launches {l32}")
    launches = {k: launches[k] + l32[k] for k in launches}

    # the sharded kernels at the cycle-0 shapes against one device
    ctx = SpmdContext(D, ["cuda:0"] * D)
    atoms = nacl_lattice(ATOMS_N)
    f = sim.make_initial_mesh()
    cut = cfg.nonzero_radius * cfg.r_c
    args = (f, sim.tab_rhs.points, atoms.positions, atoms.charges, cfg.r_c)
    one = td.density_locality_tiles(*args, cut, "cuda", c_pad=f.n_cells)
    before = td.tile_density.launches
    t0 = time.time()
    shards = ctx.density_tiles(*args, cut)
    torch.cuda.synchronize()
    s_td = time.time() - t0
    n_td = td.tile_density.launches - before
    if not torch.equal(shards, one) or n_td != D:
        raise AssertionError(f"spmd density_tiles: equal "
                             f"{torch.equal(shards, one)}, {n_td} launches")
    tab = element_tables(3, 1, 2)
    u = 0.01 * np.random.default_rng(7).standard_normal(f.dofs_of(1).n_dofs)
    fe_args = (f, tab, u, atoms.positions, atoms.charges, cfg.r_c)
    fe1 = energy_norm_error(*fe_args, "cuda", dtype=torch.float32)
    before = exact_gradient.launches
    fe_d = ctx.energy_norm_error(*fe_args, dtype=torch.float32)
    n_gr = exact_gradient.launches - before
    rel = abs(fe_d / fe1 - 1)
    print(f"[spmd x{D}] cycle-0 shapes: sharded tile density == one device "
          f"({n_td} launches, {s_td:.3f} s); sharded FE error {fe_d:.10e} vs "
          f"{fe1:.10e} (rel {rel:.2e}, {n_gr} exact-gradient launches)",
          flush=True)
    if not (rel <= 1e-6 and n_gr >= D):
        raise AssertionError(f"spmd energy_norm_error: rel {rel:.2e}, "
                             f"{n_gr} launches")
    return launches, sim


def print_residuals(tag, res):
    """Every cycle's CG count and true float64 residual, for a run that
    stops on CG's recursive residual (float32 without refinement, as the
    JAX ShardedGMG does); only a finite residual is required."""
    for r in res:
        print(f"[{tag} cycle {r['cycle']}] cg {r['cg_iterations']} true "
              f"residual {r['residual']:.3e} = "
              f"{r['residual'] / r['l2_rhs']:.3e} |b|", flush=True)
        if not np.isfinite(r["residual"]):
            raise AssertionError(f"{tag} cycle {r['cycle']}: residual "
                                 f"{r['residual']}")


def read_vtu(path):
    """(NumberOfCells, {array name: values}) of a VTU piece."""
    root = ET.parse(path).getroot()
    types = {"Float64": np.float64, "Int64": np.int64, "UInt8": np.uint8}
    arrays = {}
    for da in root.iter("DataArray"):
        text = da.text.strip()
        raw = zlib.decompress(base64.b64decode(text[44:]))
        arrays[da.get("Name") or "Points"] = np.frombuffer(
            raw, types[da.get("type")])
    return int(root.find(".//Piece").get("NumberOfCells")), arrays


def check_output(tag, out_dir, res, D):
    """Every cycle's pieces, PVTU and VisIt record parse back: D pieces
    whose cells partition the mesh, ``subdomain`` = the piece's shard,
    finite fields."""
    for r in res:
        base = os.path.join(out_dir, f"solution-{r['cycle']:05d}")
        pieces = [f"{base}.{d:04d}.vtu" for d in range(D)]
        pvtu = ET.parse(base + ".pvtu").getroot()
        listed = [p.get("Source") for p in pvtu.iter("Piece")]
        if listed != [os.path.basename(p) for p in pieces]:
            raise AssertionError(f"{tag}: PVTU lists {listed}")
        if open(base + ".visit").readline().strip() != f"!NBLOCKS {D}":
            raise AssertionError(f"{tag}: VisIt record")
        total = 0
        for d, p in enumerate(pieces):
            n, arrays = read_vtu(p)
            total += n
            if not (arrays["subdomain"] == d).all():
                raise AssertionError(f"{tag}: {p} subdomain")
            for k, v in arrays.items():
                if v.dtype == np.float64 and not np.isfinite(v).all():
                    raise AssertionError(f"{tag}: {p} {k} not finite")
        if total != r["n_cells"]:
            raise AssertionError(f"{tag}: pieces hold {total} cells, the "
                                 f"mesh {r['n_cells']}")
        print(f"[output {tag}] cycle {r['cycle']}: {D} pieces, {total} "
              f"cells, arrays {sorted(arrays)}", flush=True)


def phase_output():
    from coulomb_gmg_tpu_torch.config import (load_prm,
                                              production_scaling_config)
    from coulomb_gmg_tpu_torch.io.lammps import read_lammps_file
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation

    total = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        d1 = os.path.join(tmp, "step16")
        os.makedirs(d1)
        cfg = load_prm(os.path.join(ROOT, "examples", "step-16.prm"),
                       dtype="float32", smoother="mc_ssor",
                       n_adaptive_cycles=2, write_vtu=True, output_dir=d1)
        atoms = read_lammps_file(os.path.join(ROOT, cfg.lammps_file))
        runs.append(("step16 f32", d1, 1, Simulation(
            cfg, atoms=atoms, device="cuda", pcout=Pcout(enabled=False))))
        d2 = os.path.join(tmp, "spmd")
        os.makedirs(d2)
        cfg = production_scaling_config(1, dtype="float32", n_devices=2,
                                        n_adaptive_cycles=1, write_vtu=True,
                                        output_dir=d2)
        runs.append(("8 atoms x2", d2, 2, Simulation(
            cfg, atoms=nacl_lattice(1), device="cuda",
            pcout=Pcout(enabled=False), spmd_devices=["cuda:0"] * 2)))
        for tag, out_dir, D, sim in runs:
            reset_counts()
            t0 = time.time()
            res = sim.run()
            launches = read_counts()
            for k in KERNELS:
                total[k] += launches[k]
            print(f"[output {tag}] wall {time.time() - t0:.2f} s; cells "
                  f"{[r['n_cells'] for r in res]}; output "
                  f"{sum(r['stages'].get('Output', 0.0) for r in res):.2f} s;"
                  f" launches {launches}", flush=True)
            print_residuals(f"output {tag}", res)
            check_output(tag, out_dir, res, D)
    return total


MULTIHOST_TIMEOUT = 900


def check_multihost(tag, lines):
    """Phase 11's gates on the workers' JSON lines; returns the ELL
    launches of both ranks."""
    a, b = lines
    for r in lines:
        secs = {k: "in graphs" if v is None else f"{v:.3f} s"
                for k, v in r["comm_s"].items()}
        comm = " ".join(f"{k} {secs[k]}/{r['comm_calls'][k]}"
                        for k in sorted(secs))
        peak = ("not measured" if r["peak_gib"] is None
                else f"{r['peak_gib']:.2f} GiB")
        replay = ("none" if r["gmg_replay_ms"] is None else ", ".join(
            f"{n} {v:.4f}" for n, v in r["gmg_replay_ms"].items()))
        print(f"[{tag} rank {r['rank']}] solves: Jacobi {r['jacobi_mode']}"
              f" (capture {r['jacobi_capture_s']:.4f} s, instantiate "
              f"{r['jacobi_instantiate_s']:.4f} s); ShardedGMG "
              f"{r['gmg_mode']}, {r['gmg_reads']} reads, capture "
              f"{r['gmg_capture_s']:.4f} s, instantiate "
              f"{r['gmg_instantiate_s']:.4f} s, warm-up {r['gmg_warmup']}, "
              f"replay ms {replay}; eager loops across the processes: "
              f"solve {r['gmg_eager_solve_s']:.3f} s, the same bits, counts "
              f"and reads {r['eager_equal']}", flush=True)
        print(f"[{tag} rank {r['rank']}] {r['device']} shards {r['shards']}; "
              f"wall {r['wall_s']:.2f} s (problem {r['problem_s']:.2f} s, "
              f"ShardedGMG build {r['gmg_build_s']:.2f} s, solve "
              f"{r['gmg_solve_s']:.3f} s); Jacobi CG {r['iters']}, GMG CG "
              f"{r['gmg_iters']} over {r['gmg_levels']} levels, coarse CG "
              f"{r['coarse_cg']}; true residual {r['gmg_true_rel_res']:.3e} "
              f"|b|; per V-cycle: halo {r['halo_bytes_per_vcycle']:.0f} B, "
              f"coarse gather {r['coarse_bytes_per_vcycle']:.0f} B sent; "
              f"collectives (GMG solve) {comm}; ELL launches "
              f"{r['ell_launches']}; peak {peak}", flush=True)
    one = a.get("one_process_equal", {})
    other = a.get("other_form_equal", {})
    print(f"[{tag}] {a['n_cells']} cells, {a['n_dofs']} dofs; checksums "
          f"{a['checksum']!r} / {b['checksum']!r}, GMG {a['gmg_checksum']!r}"
          f" / {b['gmg_checksum']!r}; one process == two: {one}, eager one "
          f"process == two: {other}; all-gather"
          f" == halo: {[r['gather_equal'] for r in lines]}; one-process GMG "
          f"solve {a.get('one_process_gmg_solve_s', float('nan')):.3f} s",
          flush=True)
    bad = []
    if not (a["iters"] == b["iters"] > 0 and a["gmg_iters"] == b["gmg_iters"]
            and 1 <= a["gmg_iters"] <= 20):
        bad.append("iteration counts")
    if not (a["checksum"] == b["checksum"]
            and a["gmg_checksum"] == b["gmg_checksum"]):
        bad.append("checksums differ between ranks")
    if not (a["local_norm"] != b["local_norm"]
            and a["gmg_local_norm"] != b["gmg_local_norm"]):
        bad.append("the ranks hold the same half")
    if one != {"jacobi": True, "gmg": True} or other != one:
        bad.append("not equal to the one-process solves")
    mode = ("stepped, CUDA graphs: 2 processes (nccl)"
            if a["backend"] == "nccl" else
            "stepped, uncaptured: 2 processes (gloo)")
    if not all(r["fused"] and r["gmg_mode"] == r["jacobi_mode"] == mode
               for r in lines):
        bad.append(f"not the stepped solves {mode!r}")
    if a["backend"] == "nccl" and not all(
            r["gmg_replay_ms"] and r["gmg_warmup"].get("launches", 0) > 0
            for r in lines):
        bad.append("no graph replays or warm-up")
    if not all(r["eager_equal"] == {"jacobi": True, "gmg": True}
               for r in lines):
        bad.append("the stepped solves are not the ranks' eager loops")
    if not all(all(r["gather_equal"].values()) for r in lines):
        bad.append("the all-gather import differs from the halo plan")
    if not all(r["gmg_true_rel_res"] <= 1.01e-8 for r in lines):
        bad.append("true residual above 1.01e-8 |b|")
    if not all(r["ell_launches"] > 0 for r in lines):
        bad.append("a rank launched no ELL kernel")
    if not a["n_cells"] == REF_CELLS[2]:
        bad.append(f"{a['n_cells']} cells, not {REF_CELLS[2]}")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    return sum(r["ell_launches"] for r in lines)


def phase_multihost():
    import torch
    from coulomb_gmg_tpu_torch.parallel.multihost import launch
    t0 = time.time()
    lines = launch(["cuda:0", "cuda:0"], "gloo", "8k", MULTIHOST_TIMEOUT)
    print(f"[multihost gloo] two processes on cuda:0: {time.time() - t0:.2f}"
          " s", flush=True)
    ell = check_multihost("multihost gloo", lines)
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.time()
        lines = launch(["cuda:0", "cuda:1"], "nccl", "8k",
                       MULTIHOST_TIMEOUT)
        print(f"[multihost nccl] one process per card: "
              f"{time.time() - t0:.2f} s", flush=True)
        ell += check_multihost("multihost nccl", lines)
    else:
        print(f"[multihost nccl] not run: {n} CUDA card visible, and NCCL "
              "needs a card per rank (two ranks on one card are refused)",
              flush=True)
    return dict.fromkeys(KERNELS, 0) | {"ell_spmv": ell}


BENCH_TIMEOUT = 300        # the 8k bench: warm-up and one run, ~30 s


def phase_bench():
    import torch
    from coulomb_gmg_tpu_torch.bench import REF_CELLS, RUN_TAG
    from coulomb_gmg_tpu_torch.parallel.multihost import env_with_root
    # the bench's own budget ends first and kills its worker
    env = env_with_root(BENCH_N=str(ATOMS_N), BENCH_RUNS="1",
                        BENCH_BUDGET_S=str(BENCH_TIMEOUT - 60))
    env.pop("BENCH_FE", None)
    p = subprocess.run([sys.executable, "-m", "coulomb_gmg_tpu_torch.bench",
                        "--config", "gpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0:
        raise AssertionError(f"bench exited {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    line = json.loads(lines[-1])
    print(f"[bench] {lines[-1]}", flush=True)
    runs = [json.loads(ln[len(RUN_TAG):]) for ln in lines
            if ln.startswith(RUN_TAG)]
    if "_INVALID" in line["metric"] or len(runs) != 1:
        raise AssertionError(f"bench: invalid headline {line}")
    if line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench: device {line['device']!r}")
    rec = runs[0]
    print(f"[bench] cells {rec['cells']} CG {rec['cg']} launches "
          f"{rec['launches']} peak {rec['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    if rec["cells"] != REF_CELLS[8 * ATOMS_N ** 3]:
        raise AssertionError(f"bench: cells {rec['cells']}")
    for name in ("tile_density", "ell_spmv"):
        if rec["launches"][name] <= 0:
            raise AssertionError(f"bench: no {name} launch")
    return dict.fromkeys(KERNELS, 0) | rec["launches"]


RC_TOL = 1e-11             # card against CPU, each cutoff's L2 error


def phase_tools():
    """The port's studies and profilers on the card, each through its
    entry point's ``main``: the cutoff study (its L2 column held to a CPU
    run of the same study), the kernel benchmark at its three sizes (every
    row must pass), the V-cycle and solves of the 8k system by piece, the
    FE-error stage at 64,000 atoms over 28 chunks, and the setup pieces of
    the 1,000-atom run's final mesh.  Returns each tool's seconds."""
    import torch
    from coulomb_gmg_tpu_torch import (bench_kernels, profile_enorm,
                                       profile_pieces, profile_setup,
                                       rc_sweep)
    seconds = {}

    def timed(name, fn):
        t = time.time()
        out = fn()
        seconds[name] = round(time.time() - t, 2)
        return out

    card = timed("rc_sweep", lambda: rc_sweep.main(
        ["--out", os.path.join(ROOT, "build", "rc_sweep")]))
    cpu = timed("rc_sweep cpu", lambda: rc_sweep.sweep(
        20, 2.0, 6.0, 0.25, torch.device("cpu")))
    if [r["cutoff"] for r in card] != [r["cutoff"] for r in cpu]:
        raise AssertionError("rc_sweep: the card's cutoffs differ")
    diff = max(abs(a["L2"] - b["L2"]) for a, b in zip(card, cpu))
    l2 = [round(r["L2"], 12) for r in card]
    print(f"[tools] rc_sweep L2 column (card): {l2}; max |card - cpu| "
          f"{diff:.3e}", flush=True)
    if not diff <= RC_TOL:
        raise AssertionError(f"rc_sweep: card and CPU differ by {diff:.3e}")
    rows = timed("bench_kernels", lambda: bench_kernels.main(
        ["--json", "--op-rates"]))
    failed = [r for r in rows if not r.get("pass", True)]
    if failed or not any("kernel" in r for r in rows):
        raise AssertionError(f"bench_kernels: failed rows {failed}")
    prof = timed("profile_pieces", lambda: profile_pieces.main(
        ["--n", str(ATOMS_N)]))
    for r in prof["records"]:
        if "piece" in r:
            g = "-" if r["graph_ms"] is None else f"{r['graph_ms']:.4f}"
            print(f"[tools] piece {r['piece']:12s} level {r['level']}: "
                  f"eager {r['eager_ms']:.4f} ms, graph {g} ms", flush=True)
    del prof
    gc.collect()
    torch.cuda.empty_cache()
    timed("profile_enorm", lambda: profile_enorm.main(["--chunks", "28"]))
    timed("profile_setup", lambda: profile_setup.main(["5"]))
    print(f"[tools] seconds {seconds}", flush=True)
    return seconds


def replay_ms(stepped, names, flag):
    """Milliseconds of one replay of each named graph of a stepped solve
    (``Segments.replay_ms``: all its cards together), and of one read of
    ``flag`` (the solve's or the coarse CG's).  The replays overwrite the
    solve's state: call it after its result is taken."""
    out = stepped.segments.replay_ms(names)
    flag.tolist()
    t = time.perf_counter()
    for _ in range(200):
        flag.tolist()
    out["read"] = (time.perf_counter() - t) * 1e3 / 200
    return out


def pool_text(segments):
    """Reserved and allocated MiB of the memory pool that a stepped
    solve's graphs share."""
    import torch
    pool = tuple(next(iter(segments.graphs.values())).pool())
    segs = [sg for sg in torch.cuda.memory_snapshot()
            if tuple(sg.get("segment_pool_id", ())) == pool]
    return (f"{sum(sg['total_size'] for sg in segs) / 2**20:.1f} MiB "
            f"reserved, {sum(sg['allocated_size'] for sg in segs) / 2**20:.1f}"
            f" MiB allocated")


def fused_run(fused, n, cells):
    """One float32 production run of the 8 n^3-atom lattice with
    ``solve_fused=fused``; records every cycle's solution and, per solve,
    its CG count, host reads and the cycle's capture seconds."""
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.solver.cg import to_host
    from coulomb_gmg_tpu_torch.solver.device_gmg import StencilGMG
    cfg = production_scaling_config(n, dtype="float32", solve_fused=fused)
    solves = []
    plain_solve = StencilGMG.solve

    def captured(self):
        seg = self.stepped.segments if self.stepped is not None else None
        return ((seg.capture_s, seg.instantiate_s,
                 seg.warmup.get("launches", 0)) if seg else (0.0, 0.0, 0))

    def solve(self, *a, **kw):
        r0, c0 = to_host.reads, captured(self)
        out = plain_solve(self, *a, **kw)
        c1 = captured(self)
        solves.append(dict(k=out[1], reads=to_host.reads - r0,
                           graphs=self.stepped is not None,
                           capture_s=c1[0] - c0[0],
                           instantiate_s=c1[1] - c0[1],
                           warmup=c1[2] - c0[2],
                           peak=torch.cuda.max_memory_allocated() / 2**30))
        return out

    StencilGMG.solve = solve
    try:
        sim, res, launches, _ = run_study(f"fused={fused}", cfg, n, cells)
    finally:
        StencilGMG.solve = plain_solve
    peak = torch.cuda.max_memory_allocated() / 2**30
    return dict(sim=sim, res=res, launches=launches, solves=solves,
                peak=peak, solve_s=sum(r["stages"]["Solve"] for r in res))


def record_solutions(sim_cls):
    """Patch ``sim_cls.solve`` to keep a copy of every cycle's solution;
    returns the list and the function that restores the class."""
    sols = []
    plain = sim_cls.solve

    def solve(self):
        plain(self)
        sols.append(np.array(self.solution, copy=True))
    sim_cls.solve = solve
    return sols, lambda: setattr(sim_cls, "solve", plain)


def phase_fused(n=ATOMS_N):
    """Phase 12 at 8,000 atoms; ``phase_fused(20)`` makes the same
    comparison at 64,000 atoms (without the 8k CG anchors)."""
    import torch
    from coulomb_gmg_tpu_torch.driver import Simulation
    cells = REF_CELLS if n == ATOMS_N else REF_CELLS_64K
    runs = {}
    for fused in (False, True):
        sols, restore = record_solutions(Simulation)
        try:
            runs[fused] = fused_run(fused, n, cells)
        finally:
            restore()
        runs[fused]["sols"] = sols
        if not fused:           # free the eager run before the graph run
            del runs[fused]["sim"]
            gc.collect()
    e, g = runs[False], runs[True]
    for tag, r in (("eager", e), ("graph", g)):
        cap = " ".join(f"{s['capture_s']:.4f}/{s['instantiate_s']:.4f}"
                       for s in r["solves"] if s["capture_s"] > 0) or "none"
        print(f"[fused {tag}] passes {[x['cg_passes'] for x in r['res']]}; "
              f"reads per solve {[(s['k'], s['reads']) for s in r['solves']]}"
              f" (k, reads); capture/instantiate s per cycle {cap}; Solve "
              f"{r['solve_s']:.4f} s; ELL launches {r['launches']['ell_spmv']}"
              f", of them warm-ups {[s['warmup'] for s in r['solves']]};"
              f" peak {r['peak']:.3f} GiB, after each solve "
              f"{[round(s['peak'], 3) for s in r['solves']]}", flush=True)
    same = [bool(np.array_equal(a, b)) for a, b in zip(e["sols"], g["sols"])]
    costs = replay_ms(g["sim"].gmg.stepped, ("step",),
                      g["sim"].gmg.stepped.active)
    print(f"[fused] the last cycle's graph pool: "
          f"{pool_text(g['sim'].gmg.stepped.segments)}", flush=True)
    g["sim"].gmg.release()
    print(f"[fused] solutions equal per cycle {same}; Solve eager "
          f"{e['solve_s']:.4f} s, graph {g['solve_s']:.4f} s; last cycle: "
          f"step replay {costs['step']:.4f} ms, read {costs['read']:.4f} ms "
          f"(one replay a read)", flush=True)
    bad = []
    if [r["cg_passes"] for r in e["res"]] != [r["cg_passes"] for r in
                                                g["res"]]:
        bad.append("CG counts per pass differ")
    if len(same) != len(REF_CELLS) or not all(same):
        bad.append("solutions differ")
    warmup = sum(s["warmup"] for s in g["solves"])
    if g["launches"] != e["launches"] | {
            "ell_spmv": e["launches"]["ell_spmv"] + warmup} or warmup <= 0:
        bad.append(f"launches {g['launches']} != {e['launches']} + "
                   f"{warmup} ELL warm-ups")
    if n == ATOMS_N and [r["cg_iterations"] for r in g["res"]] != EARLIER_CG:
        bad.append("CG counts differ from the earlier runs'")
    over = [s for s in g["solves"] if s["reads"] > s["k"] + 2]
    if over or not all(s["graphs"] for s in g["solves"]):
        bad.append(f"graph solves over their reads or eager: {over}")
    if sum(s["capture_s"] > 0 for s in g["solves"]) != len(REF_CELLS):
        bad.append("not one capture per cycle")
    if any(s["graphs"] for s in e["solves"]):
        bad.append("the eager run made graphs")
    if bad:
        raise AssertionError("fused: " + "; ".join(bad))
    return {k: e["launches"][k] + g["launches"][k] for k in KERNELS}


def sharded_gmg_both(sg, rhs, rtol):
    """The eager, then the stepped solve of one ShardedGMG from zero;
    per form the solution, counts, norms, coarse iterations per V-cycle,
    launches, solve_info, seconds and peak memory."""
    import torch
    out = {}
    for fused in (False, True):
        sg.fused = fused
        n0 = len(sg.coarse_iterations)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        before = card_launches()
        t0 = time.perf_counter()
        x, k, res0, res = sg.solve(rhs, None, rtol=rtol)
        secs = time.perf_counter() - t0
        out[fused] = dict(x=x, k=k, res0=res0, res=res, s=secs,
                          coarse=sg.coarse_iterations[n0:],
                          launches=read_counts(), info=sg.solve_info(),
                          cards=card_launches(before),
                          peak=torch.cuda.max_memory_allocated() / 2**30)
    return out


def card_launches(before=None):
    """ELL launches by card index (kernels.LAUNCHES), less ``before``."""
    from coulomb_gmg_tpu_torch import kernels
    now = {i: n for (what, i), n in kernels.LAUNCHES.items()
           if what == "ell_spmv"}
    if before is None:
        return now
    return {i: n - before.get(i, 0) for i, n in now.items()
            if n != before.get(i, 0)}


def phase_sharded_fused(sim):
    """Phase 13 on the final system of phase 9's float64 SPMD run (its
    ShardedGMG, 4 shards on cuda:0), then the sharded Jacobi-CG on a 64^3
    Poisson matrix at 4 shards: each eager, then stepped."""
    import torch
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.parallel.multihost import poisson_7pt
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    sg, rhs, bad = sim.gmg, np.asarray(sim.rhs), []
    out = sharded_gmg_both(sg, rhs, sim.cfg.cg_rtol)
    e, g = out[False], out[True]
    st = sg.stepped
    costs = replay_ms(st, ("step_head", "coarse", "step_tail"),
                      st.coarse0.info)
    pool = pool_text(st.segments)
    sg.release()
    op = next(iter(sg._coarse_ops.values()))[0]     # (Slices, vals)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        op[0].n_rows)).to(op[1].device)
    ell_layouts("sharded fused level 0 (gathered)", op, x0, lib=True)
    A64 = sim.A.ell(dtype=torch.float64)
    xd = torch.from_numpy(g["x"]).cuda()
    true = float(torch.linalg.vector_norm(torch.from_numpy(rhs).cuda()
                                          - ell_mv(*A64, xd)))
    bnorm = float(np.linalg.norm(rhs))
    for tag, r in (("eager", e), ("graph", g)):
        print(f"[sharded fused {tag}] {r['info']['mode']}: CG {r['k']}, "
              f"|r0| {r['res0']:.6e} |r| {r['res']:.6e}, coarse CG per "
              f"V-cycle {r['coarse']}; reads {r['info']['reads']}; solve "
              f"{r['s']:.4f} s; ELL launches {r['launches']['ell_spmv']}; "
              f"capture {r['info'].get('capture_s', 0.0):.4f} s, instantiate "
              f"{r['info'].get('instantiate_s', 0.0):.4f} s, warm-up "
              f"{r['info'].get('warmup', {})}; peak {r['peak']:.3f} GiB",
              flush=True)
    print(f"[sharded fused] {sim.forest.n_cells} cells, {sg.n} dofs, "
          f"{len(sg.levels)} levels; solve eager {e['s']:.4f} s, graph "
          f"{g['s']:.4f} s; replay ms: " + ", ".join(
              f"{n} {v:.4f}" for n, v in costs.items())
          + f"; graph pool {pool}; true residual {true / bnorm:.3e} |b|",
          flush=True)
    warm = g["info"]["warmup"].get("launches", 0)
    if not (np.array_equal(e["x"], g["x"]) and e["k"] == g["k"]
            and e["res0"] == g["res0"] and e["res"] == g["res"]):
        bad.append("GMG: solutions or norms differ")
    if e["coarse"] != g["coarse"] or len(g["coarse"]) != g["k"] + 1:
        bad.append("GMG: coarse iterations differ")
    if not (warm > 0 and g["launches"] == e["launches"] | {
            "ell_spmv": e["launches"]["ell_spmv"] + warm}):
        bad.append(f"GMG: launches {g['launches']} != {e['launches']} + "
                   f"{warm} ELL warm-ups")
    for r in (e, g):
        if r["info"]["reads"] != r["k"] + 1 + sum(kc + 1
                                                  for kc in r["coarse"]):
            bad.append(f"GMG: {r['info']['reads']} reads")
    if g["info"]["mode"] != "stepped, CUDA graphs: 4 shards on cuda:0":
        bad.append(f"GMG mode {g['info']['mode']!r}")
    if not (1 <= g["k"] <= 20 and true <= 1.01e-8 * bnorm):
        bad.append(f"GMG: CG {g['k']}, true residual {true / bnorm:.3e}")
    launches = {k: e["launches"][k] + g["launches"][k] for k in KERNELS}

    D, m = 4, 64
    rows, cols, vals, n = poisson_7pt(m)
    ctx = SpmdContext(D, ["cuda:0"] * D)
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    b = put_blocks(shard_vector(np.random.default_rng(7).standard_normal(n),
                                D), ctx)
    jac = {}
    for fused in (False, True):
        solver = make_sharded_solver(ctx, A, sharded_diag(A, D),
                                     tol_rtol=1e-10, maxiter=4000,
                                     fused=fused)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        torch.cuda.synchronize()
        jac[fused] = dict(x=torch.cat(xb), k=k, res0=res0, res=res,
                          s=time.perf_counter() - t0, info=solver.info,
                          launches=read_counts())
        r = jac[fused]
        print(f"[sharded jacobi {m}^3 x{D} fused={fused}] "
              f"{r['info']['mode']}: CG {k}, |r|/|r0| {res / res0:.3e}; "
              f"reads {r['info']['reads']}; solve {r['s']:.4f} s; ELL "
              f"launches {r['launches']['ell_spmv']}; capture "
              f"{r['info'].get('capture_s', 0.0):.4f} s", flush=True)
    je, jg = jac[False], jac[True]
    warm = jg["info"]["warmup"].get("launches", 0)
    if not (torch.equal(je["x"], jg["x"]) and je["k"] == jg["k"]
            and je["res"] == jg["res"] and 10 <= jg["k"] < 4000):
        bad.append("Jacobi: solutions or counts differ")
    if not jg["info"]["reads"] == je["info"]["reads"] == jg["k"] + 2:
        bad.append("Jacobi: reads")
    if not (warm > 0 and jg["launches"]["ell_spmv"]
            == je["launches"]["ell_spmv"] + warm):
        bad.append("Jacobi: launches")
    if bad:
        raise AssertionError("sharded fused: " + "; ".join(bad))
    for k in KERNELS:
        launches[k] += je["launches"][k] + jg["launches"][k]
    across = sharded_across_cards(sim, g, (m, jg))
    return {k: launches[k] + across[k] for k in KERNELS}


def sharded_across_cards(sim, one, jacobi):
    """Phase 13 on ``min(4, device_count)`` cards, one shard a card, one
    process: phase 9's last system by ``ShardedGMG`` and the 64^3 sharded
    Jacobi-CG, each eager, then captured (one graph over all the cards a
    segment).  The same bits, counts and host reads both ways, and those
    of the one-card captured solve of as many shards (``one`` and the
    Jacobi result in ``jacobi`` are phase 13's, of 4 shards); ELL
    launches on every card.  With one card it says that it did not
    run."""
    import torch
    from coulomb_gmg_tpu_torch.parallel.multihost import poisson_7pt
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[sharded cards] not run: {n_cards} CUDA card visible; a "
              "shard a card needs two or more", flush=True)
        return dict.fromkeys(KERNELS, 0)
    N = min(4, n_cards)
    cards = [f"cuda:{i}" for i in range(N)]
    peer = [[torch.cuda.can_device_access_peer(i, j) for j in range(N)
             if j != i] for i in range(N)]
    ctx = SpmdContext(N, cards)
    mode = f"stepped, CUDA graphs: {N} shards on {N} cards"
    t0 = time.perf_counter()
    levels = sim.level_gmg()
    sg = ShardedGMG(levels, sim.A, ctx, dtype=sim.dtype,
                    maxiter=sim.cfg.cg_max_iters)
    build_s = time.perf_counter() - t0
    rhs = np.asarray(sim.rhs)
    out = sharded_gmg_both(sg, rhs, sim.cfg.cg_rtol)
    e, g = out[False], out[True]
    st = sg.stepped
    costs = replay_ms(st, ("step_head", "coarse", "step_tail"),
                      st.coarse0.info)
    pool = pool_text(st.segments)
    sg.release()
    if N != 4:        # the one-card solve of as many shards
        one = sharded_gmg_both(ShardedGMG(
            levels, sim.A, SpmdContext(N, ["cuda:0"] * N), dtype=sim.dtype,
            maxiter=sim.cfg.cg_max_iters), rhs, sim.cfg.cg_rtol)[True]
    for tag, r in (("eager", e), ("graph", g)):
        print(f"[sharded cards {tag}] {r['info']['mode']}: CG {r['k']}, "
              f"coarse CG per V-cycle {r['coarse']}; reads "
              f"{r['info']['reads']}; solve {r['s']:.4f} s; ELL launches "
              f"by card {r['cards']}; capture "
              f"{r['info'].get('capture_s', 0.0):.4f} s, instantiate "
              f"{r['info'].get('instantiate_s', 0.0):.4f} s, warm-up "
              f"{r['info'].get('warmup', {})}", flush=True)
    print(f"[sharded cards] {N} cards, peer access {peer}; ShardedGMG "
          f"build {build_s:.2f} s; solve eager {e['s']:.4f} s, graph "
          f"{g['s']:.4f} s, one card ({one['info']['mode']}) "
          f"{one['s']:.4f} s; replay ms (all cards): " + ", ".join(
              f"{n} {v:.4f}" for n, v in costs.items())
          + f"; graph pool on cuda:0 {pool}", flush=True)
    bad = []
    warm = g["info"]["warmup"].get("launches", 0)
    if not (np.array_equal(e["x"], g["x"]) and e["k"] == g["k"]
            and e["res0"] == g["res0"] and e["res"] == g["res"]
            and e["coarse"] == g["coarse"]
            and e["info"]["reads"] == g["info"]["reads"]
            == g["k"] + 1 + sum(kc + 1 for kc in g["coarse"])):
        bad.append("GMG: the captured solve is not the eager loops")
    if not (np.array_equal(one["x"], g["x"]) and one["k"] == g["k"]
            and one["coarse"] == g["coarse"]):
        bad.append("GMG: not the one-card captured solve")
    if g["info"]["mode"] != mode:
        bad.append(f"GMG mode {g['info']['mode']!r}")
    if not (warm > 0 and g["launches"]["ell_spmv"]
            == e["launches"]["ell_spmv"] + warm):
        bad.append("GMG: launches")
    if not all(r["cards"].get(i, 0) > 0 for r in (e, g) for i in range(N)):
        bad.append(f"GMG: ELL launches by card {e['cards']} / "
                   f"{g['cards']}")
    launches = {k: e["launches"][k] + g["launches"][k] for k in KERNELS}

    m, jac_one = jacobi    # the one-card Jacobi run's size and result
    rows, cols, vals, n = poisson_7pt(m)
    A = ShardedCSR.from_coo(rows, cols, vals, n, N)
    b = put_blocks(shard_vector(np.random.default_rng(7).standard_normal(n),
                                N), ctx)
    jac = {}
    for fused in (False, True):
        solver = make_sharded_solver(ctx, A, sharded_diag(A, N),
                                     tol_rtol=1e-10, maxiter=4000,
                                     fused=fused)
        torch.cuda.synchronize()
        reset_counts()
        before = card_launches()
        t0 = time.perf_counter()
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        for c in cards:
            torch.cuda.synchronize(c)
        jac[fused] = dict(x=torch.cat([x.cpu() for x in xb]), k=k, res=res,
                          s=time.perf_counter() - t0, info=solver.info,
                          launches=read_counts(),
                          cards=card_launches(before))
        r = jac[fused]
        print(f"[sharded cards jacobi {m}^3 x{N} fused={fused}] "
              f"{r['info']['mode']}: CG {k}; reads {r['info']['reads']}; "
              f"solve {r['s']:.4f} s; ELL launches by card {r['cards']}; "
              f"capture {r['info'].get('capture_s', 0.0):.4f} s",
              flush=True)
    je, jg = jac[False], jac[True]
    if not (torch.equal(je["x"], jg["x"]) and je["k"] == jg["k"]
            and je["res"] == jg["res"]
            and je["info"]["reads"] == jg["info"]["reads"] == jg["k"] + 2):
        bad.append("Jacobi: the captured solve is not the eager loop")
    if N == 4 and not (torch.equal(jac_one["x"].cpu(), jg["x"])
                       and jac_one["k"] == jg["k"]):
        bad.append("Jacobi: not the one-card captured solve")
    if jg["info"]["mode"] != mode or not all(
            r["cards"].get(i, 0) > 0 for r in (je, jg) for i in range(N)):
        bad.append(f"Jacobi: mode {jg['info']['mode']!r}, ELL launches by "
                   f"card {je['cards']} / {jg['cards']}")
    if bad:
        raise AssertionError("sharded cards: " + "; ".join(bad))
    for k in KERNELS:
        launches[k] += je["launches"][k] + jg["launches"][k]
    return launches


def spmd_solve_pair(D=4):
    """Phase 9's float64 study on D shards of cuda:0 with ``solve_fused``
    off, then on, in one process (not a phase of the smoke run:
    ``python3 -c "import chip_smoke as c; c.phase_build();
    c.spmd_solve_pair()"``).  Per cycle it prints the "Solve" stage and
    the ``ShardedGMG.solve`` seconds inside it, CG, host reads and capture
    seconds; the two runs must give the same cells, CG and solutions."""
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
    plain = ShardedGMG.solve
    runs = {}
    for fused in (False, True):
        solves = []

        def solve(self, *a, **kw):
            t0 = time.perf_counter()
            out = plain(self, *a, **kw)
            solves.append((time.perf_counter() - t0, out[1],
                           self.solve_info()))
            return out
        sols, restore = record_solutions(Simulation)
        ShardedGMG.solve = solve
        try:
            cfg = production_scaling_config(ATOMS_N, dtype="float64",
                                            n_devices=D,
                                            solve_fused=fused)
            sim, res, _, _ = run_study(f"spmd x{D} fused={fused}", cfg,
                                       spmd_devices=["cuda:0"] * D)
        finally:
            ShardedGMG.solve = plain
            restore()
        del sim
        gc.collect()
        stage = [r["stages"]["Solve"] for r in res]
        runs[fused] = dict(sols=sols, cg=[r["cg_iterations"] for r in res],
                           cells=[r["n_cells"] for r in res])
        cap = [round(i.get("capture_s", 0.0) + i.get("instantiate_s", 0.0),
                     4) for _, _, i in solves]
        print(f"[spmd pair fused={fused}] Solve stage "
              f"{sum(stage):.4f} s = {[round(x, 4) for x in stage]}; "
              f"ShardedGMG.solve {sum(x[0] for x in solves):.4f} s = "
              f"{[round(x[0], 4) for x in solves]}; reads "
              f"{[i['reads'] for _, _, i in solves]}; capture+instantiate "
              f"{cap}; mode {solves[-1][2]['mode']}", flush=True)
    e, g = runs[False], runs[True]
    same = [bool(np.array_equal(a, b)) for a, b in zip(e["sols"],
                                                     g["sols"])]
    print(f"[spmd pair] CG {e['cg']} / {g['cg']}; solutions equal {same}",
          flush=True)
    if e["cg"] != g["cg"] or e["cells"] != g["cells"] or not all(same):
        raise AssertionError("spmd pair: the two runs differ")


def sharded_solve_pairs(n=10, D=4):
    """Phase 9's float64 study on D shards of cuda:0, then ``n`` pairs of
    solves of its last system from zero, eager and stepped, the order
    alternating from pair to pair; each stepped solve captures its graphs
    anew, as the driver's once-a-cycle ``ShardedGMG`` does.  Then ``n``
    stepped solves on kept graphs.  Every solve must give the first one's
    bits.  Not a phase of the smoke run: ``python3 -c "import chip_smoke
    as c; c.phase_build(); c.sharded_solve_pairs()"``."""
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    cfg = production_scaling_config(ATOMS_N, dtype="float64", n_devices=D)
    sim, _, _, _ = run_study(f"spmd x{D}", cfg,
                             spmd_devices=["cuda:0"] * D)
    sg, rhs = sim.gmg, np.asarray(sim.rhs)

    def solve(fused, keep=False):
        if not keep:
            sg.release()
        sg.fused = fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, k = sg.solve(rhs, None, rtol=cfg.cg_rtol)[:2]
        return time.perf_counter() - t0, x, k

    times = {False: [], True: []}
    ref = None
    for i in range(n):
        for fused in ((False, True) if i % 2 == 0 else (True, False)):
            s, x, k = solve(fused)
            times[fused].append(s)
            ref = ref or (x, k)
            if not (np.array_equal(x, ref[0]) and k == ref[1]):
                raise AssertionError("sharded pairs: a solve differs")
    solve(True)
    kept = [solve(True, keep=True)[0] for _ in range(n)]
    sg.release()
    q = lambda v: np.percentile(v, [25, 50, 75])
    wins = sum(g < e for e, g in zip(times[False], times[True]))
    for tag, v in (("eager", times[False]), ("graph", times[True]),
                   ("graph, kept graphs", kept)):
        print(f"[sharded pairs] {tag}: quartiles "
              f"{' / '.join(f'{x:.4f}' for x in q(v))} s; runs "
              f"{[round(x, 4) for x in v]}", flush=True)
    print(f"[sharded pairs] CG {ref[1]}; the graph solve faster in {wins} "
          f"of {n} pairs", flush=True)


def main():
    t0 = time.time()
    smi = phase_device()
    import torch
    seconds = {}

    def timed(name, fn):
        t = time.time()
        out = fn()
        seconds[name] = round(time.time() - t, 2)
        print(f"[smoke] phase {name}: {seconds[name]:.2f} s", flush=True)
        return out

    timed("build", phase_build)
    timing = timed("kernels", phase_kernels)
    main4, traj8k = timed("main path", phase_main_path)
    timed("topology", lambda: phase_topology(traj8k))
    main5 = timed("bruteforce fe", phase_bruteforce_fe)
    (main6, timing["ssor_sweep"], timing["list_density"],
     timing["matrix_norms"], timing["distribute_rows"]) = timed(
        "host f64", phase_host_f64)
    main7 = timed("routes", phase_routes)
    main8 = timed("device f64", phase_device_f64)
    main9, spmd_sim = timed("multi device", phase_multi_device)
    # phase 13 takes phase 9's final system, so it runs right after it
    main13 = timed("sharded fused", lambda: phase_sharded_fused(spmd_sim))
    del spmd_sim
    gc.collect()
    main10 = timed("output", phase_output)
    main11 = timed("multihost", phase_multihost)
    main12 = timed("fused", phase_fused)
    gc.collect()
    torch.cuda.empty_cache()
    main14 = timed("bench", phase_bench)
    gc.collect()
    torch.cuda.empty_cache()
    timed("tools", phase_tools)
    replaces = {"tile_density": "coulomb_gmg_tpu/ops/tile_density.py:179",
                "ell_spmv": "coulomb_gmg_tpu/ops/ell.py:117",
                "dense_density": "coulomb_gmg_tpu/ops/pallas_density.py:32",
                "exact_gradient": "coulomb_gmg_tpu/ops/pallas_gradient.py:45",
                "segment_sum": "no kernel: coulomb_gmg_tpu/fem/assembly.py:"
                               "253 (assemble_np, host numpy)",
                "ssor_sweep": "no kernel: coulomb_gmg_tpu/ops/smoothers.py:"
                              "make_ssor_host (host scipy)",
                "list_density": "no kernel: coulomb_gmg_tpu/ops/density.py:"
                                "compute_density (jnp list branch)",
                "matrix_norms": "no kernel: coulomb_gmg_tpu/driver.py "
                                "(the solve's host numpy matrix norms)",
                "distribute_rows": "no kernel: coulomb_gmg_tpu/fem/"
                                   "constraints.py:distribute (host loop)"}
    # launches: the sum over the main-path runs (phases 4 to 14)
    rec = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"coulomb_gmg_tpu_torch/csrc/{SOURCE[name]}.cu",
         "replaces": replaces[name],
         "launches": sum(m[name] for m in (main4, main5, main6, main7,
                                           main8, main9, main10, main11,
                                           main12, main13, main14)),
         **timing[name]}
        for name in ("tile_density", "ell_spmv", "dense_density",
                     "exact_gradient", "segment_sum", "ssor_sweep",
                     "list_density", "matrix_norms", "distribute_rows")]}
    print(f"[smoke] total {time.time() - t0:.1f} s; phases {seconds}",
          flush=True)
    print(smi)
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
