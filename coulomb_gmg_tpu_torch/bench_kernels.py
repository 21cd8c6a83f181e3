"""The four hand kernels against their plain versions, timed against their
bounds.

    python -m coulomb_gmg_tpu_torch.bench_kernels [--sizes 512,2744,8000]
        [--points 262144] [--side 64] [--op-rates] [--json]
        [--device cuda|cpu]

Counterpart of ``tools/verify_tpu_kernels.py`` (each compiled kernel held
to its reference form, then timed at three sizes), ``tools/bench_kernels.py``
(throughput against a roofline: the SpMV forms on a 7-point Poisson matrix
and the CG iteration rate) and the standalone half of ``tools/roofline.py``
(``--op-rates``).  Rows, one per (kernel, size):

* ``dense_density`` and ``exact_gradient``: ``--points`` random points
  (``points / 8`` cells of the 8-point Laplace rule for the density) in
  [0, 7]^3 against each of ``--sizes`` random atoms of charge +-1, as
  ``tools/verify_tpu_kernels.py`` draws them;
* ``tile_density``: the cycle-0 plan of ``nacl_lattice(n)`` for each size
  ``8 n^3`` of ``--sizes``, the plan of the production run;
* ``ell_spmv`` (the sliced layout of every operator built from a CSR),
  ``ell_spmv_padded`` (the padded layout of the operators built on the
  card) and ``spmv_csr`` (ops/spmv.py:CSR.matvec, the counterpart of the
  JAX tool's COO scatter-add row) on the 7-point Poisson matrix of
  ``--side``^3 rows, float32; ``library_ms`` is cuSPARSE, ``torch.mv`` on
  a CSR tensor, which the port never calls.

Each row holds ``kernel``, ``size`` (atoms, or rows for the SpMV),
``ms`` (median of ``REPS`` samples, each of back-to-back calls filling
about ``SAMPLE_MS``, timed by CUDA events; the SpMV rows as CUDA graphs of
back-to-back calls replayed in turns, since a 262,144-row product is
shorter than its wrapper's host time), ``plain_ms`` (the plain version),
``library_ms`` (null where no one PyTorch call computes the function),
``bound_ms`` and ``bound_by`` (roofline.py, from these inputs),
``share`` (bound over time), ``max_err`` (kernel against plain), ``pass``
(``max_err`` within the tolerance of ``chip_smoke.py`` phase 3: 1e-5 of
the largest value for the densities, 1e-4 for the gradient, 1e-6 for the
SpMV; the tile density's nonzero set must also equal the plain one's) and
``launches`` (the kernel launches the row made: check, warm-ups, timed
calls and graph replays).  Then one line per CG: the Jacobi-CG
(solver/fused.py:SteppedCG, the driver's route) and the Chebyshev-CG
(solver/tpu_cg.py:SteppedChebyCG) on the Poisson matrix, iterations per
second of a hot solve to 1e-6 (or to 2,000 iterations: ``converged``
says which).  ``--op-rates`` adds the rate of single torch elementwise
ops (``x * a + b``, ``exp``, ``rsqrt``, ``erf``) on a (512, 4096) float32
tile, by the slope between CUDA graphs of n and 2n chained ops, and
``tools/roofline.py``'s op-mix prediction of the pair rates from them.

On the card unless ``--device cpu`` (without a card it raises); on the
CPU each kernel's wrapper runs its plain version, so ``max_err`` is 0, no
kernel is launched and every time is the CPU's.  Each row names its
device.  Exit code 1 when a row fails its check.  The timing helpers are
``chip_smoke.py``'s too.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

REPS = 20                 # timed samples of a kernel
PLAIN_REPS = 3            # the dense plain versions take up to seconds
SAMPLE_MS = 1.0           # back-to-back calls fill a sample
R_C = 0.5
KEYS = ("kernel", "size", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "share", "max_err", "pass", "launches")


# --------------------------------------------------------------- timing

def sample_ms(fn, n: int, device=None) -> float:
    """Milliseconds of one call of ``fn`` over ``n`` back-to-back calls:
    CUDA events around them on the card (``device`` None or a card), the
    host clock on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) * 1e3 / n
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_samples(fn, reps: int = REPS, device=None) -> list:
    """Times of one call of ``fn``, ``reps`` samples after a warm-up run.
    A sample times back-to-back calls, enough to fill about SAMPLE_MS, and
    divides by their number: the card then runs the calls without waiting
    for the host to launch each one."""
    calls = min(100, max(1, int(SAMPLE_MS / sample_ms(fn, 1, device))))
    return [sample_ms(fn, calls, device) for _ in range(reps)]


def median_ms(fn, reps: int = REPS, device=None) -> float:
    """Median of :func:`time_samples`."""
    return float(np.median(time_samples(fn, reps, device)))


def graph_samples(fns: dict, reps: int = REPS, ran: dict = None) -> dict:
    """Device times of one call of each of ``fns`` (name -> callable),
    ``reps`` samples each: per callable a CUDA graph of back-to-back calls,
    enough to fill about SAMPLE_MS, captured once; then the graphs are
    replayed in turns, each replay timed by CUDA events.  No host launch
    cost enters, which :func:`time_samples` cannot avoid for a kernel
    shorter than its wrapper's host time (the ELL on a small level), and
    the turns spread any drift of the card over all of them.  ``ran``, if
    given, receives the calls of each callable that ran on the card:
    warm-up, sizing samples and replayed ones (a capture runs none)."""
    ran = {} if ran is None else ran
    graphs = {}
    for name, fn in fns.items():
        ran[name] = 0

        def counted(fn=fn, name=name):
            ran[name] += 1
            fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            counted()
        torch.cuda.current_stream().wait_stream(side)
        n = min(100, max(1, int(SAMPLE_MS / min(time_samples(counted, 3)))))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()
        ran[name] += n
        graphs[name] = (g, n)
    out = {name: [] for name in fns}
    for _ in range(reps):
        for name, (g, n) in graphs.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            out[name].append(a.elapsed_time(b) / n)
            ran[name] += n
    return out


def samples_by_device(fns: dict, device, reps: int = REPS,
                      ran: dict = None) -> dict:
    """:func:`graph_samples` on the card; on the CPU :func:`time_samples`
    of each callable."""
    if device.type == "cuda":
        return graph_samples(fns, reps, ran)
    return {name: time_samples(fn, reps, device) for name, fn in fns.items()}


def wall_s(fn, device) -> tuple:
    """``(fn(), seconds)`` on the host clock, the device synchronized
    before and after."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


# ----------------------------------------------------------------- rows

def counters() -> dict:
    """Each hand kernel's wrapper, whose ``launches`` counts its launches."""
    from coulomb_gmg_tpu_torch.ops.density import dense_density
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient
    from coulomb_gmg_tpu_torch.ops.tile_density import tile_density
    return {"tile_density": tile_density, "ell_spmv": ell_mv,
            "dense_density": dense_density, "exact_gradient": exact_gradient}


def make_row(kernel, size, ms, plain_ms, library_ms, b, err, ok, launches,
             device) -> dict:
    return {"kernel": kernel, "size": int(size), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "share": b["bound_ms"] / ms, "max_err": err, "pass": bool(ok),
            "launches": int(launches), "device": device_name(device)}


def _max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|) as floats."""
    return (float((got - ref).abs().max()), float(ref.abs().max()))


def kernel_row(name: str, size: int, kernel, plain, bound, tol: float,
               device, same_zeros: bool = False) -> dict:
    """One row: ``kernel()`` (the wrapper: the kernel on the card) against
    ``plain()``, both timed; ``bound(out)`` the roofline of the inputs;
    ``pass`` within ``tol`` of the largest plain value and, with
    ``same_zeros``, the same nonzero set."""
    count = counters()[name]
    n0 = count.launches
    got, ref = kernel(), plain()
    err, scale = _max_err(got, ref)
    ok = math.isfinite(err) and err <= tol * scale
    if same_zeros:
        ok = ok and torch.equal(got != 0, ref != 0)
    ms = median_ms(kernel, REPS, device)
    plain_ms = median_ms(plain, PLAIN_REPS, device)
    return make_row(name, size, ms, plain_ms, None, bound(got), err, ok,
                    count.launches - n0, device)


def dense_inputs(A: int, points: int, rng, device) -> tuple:
    """``(args, kw)`` of the brute-force density: ``points`` random points
    as cells of the 8-point Laplace rule (h = 0.25) in [0, 7]^3, ``A``
    random atoms of charge +-1 there."""
    from coulomb_gmg_tpu_torch.ops.density import pack_atoms
    from coulomb_gmg_tpu_torch.ops.q1 import element_tables
    pref = element_tables(3, 1, 2).points
    C = max(points // len(pref), 1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(device)
    pos = rng.uniform(0.0, 7.0, (A, 3))
    q = rng.choice([-1.0, 1.0], A)
    args = (put(rng.uniform(0.0, 6.75, (C, 3))), put(np.full(C, 0.25)),
            put(pref), pack_atoms(pos, q, device))
    const = 4.0 * np.pi / (R_C ** 3 * np.pi ** 1.5)
    return args, dict(inv_rc2=float(np.float32(1.0 / R_C ** 2)),
                      scale=float(np.float32(const)), n_out=C)


def dense_rows(sizes, points: int, device, rng) -> list:
    """The brute-force density at ``points`` random points against each
    size of random atoms (:func:`dense_inputs`)."""
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import density as dd
    rows = []
    for A in sizes:
        args, kw = dense_inputs(A, points, rng, device)
        rows.append(kernel_row(
            "dense_density", A, lambda: dd.dense_density(*args, **kw),
            lambda: dd.dense_density_plain(*args, **kw),
            lambda out: roofline.dense_density(args, kw, out), 1e-5, device))
    return rows


def gradient_inputs(A: int, points: int, rng, device) -> tuple:
    """``(points (P, 3), atoms (A, 4))`` of the exact gradient: random in
    [0, 7]^3, charges +-1."""
    from coulomb_gmg_tpu_torch.ops.density import pack_atoms
    pos = rng.uniform(0.0, 7.0, (A, 3))
    q = rng.choice([-1.0, 1.0], A)
    atoms = pack_atoms(pos, q, device)
    return torch.from_numpy(rng.uniform(0.0, 7.0, (points, 3)).astype(
        np.float32)).to(device), atoms


def gradient_rows(sizes, points: int, device, rng) -> list:
    """The exact gradient at ``points`` random points against each size of
    random atoms (:func:`gradient_inputs`)."""
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import gradient as gr
    rows = []
    for A in sizes:
        pts, atoms = gradient_inputs(A, points, rng, device)
        rows.append(kernel_row(
            "exact_gradient", A, lambda: gr.exact_gradient(pts, atoms, R_C),
            lambda: gr.exact_gradient_plain(pts, atoms, R_C),
            lambda out: roofline.exact_gradient(pts, atoms, gr.far_r2(R_C)),
            1e-4, device))
    return rows


def lattice_n(atoms: int) -> int:
    """``n`` of ``nacl_lattice(n)`` for ``8 n^3`` atoms."""
    n = round((atoms / 8) ** (1 / 3))
    if 8 * n ** 3 != atoms:
        raise ValueError(f"tile_density: {atoms} atoms is not 8 n^3")
    return n


def tile_rows(sizes, device) -> list:
    """The tile density on the cycle-0 plan of the production run of
    ``nacl_lattice(n)``, for each size ``8 n^3``."""
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.ops import tile_density as td
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    rows = []
    for A in sizes:
        n = lattice_n(A)
        cfg = production_scaling_config(n, dtype="float32")
        atoms = nacl_lattice(n)
        sim = Simulation(cfg, atoms=atoms, device=device,
                         pcout=Pcout(enabled=False))
        f = sim.make_initial_mesh()
        cut = cfg.nonzero_radius * cfg.r_c
        plan = td.build_tile_plan(f, len(sim.tab_rhs.points),
                                  atoms.positions, atoms.charges, cut,
                                  n_rows=f.n_cells + 1)
        args, kw = td.plan_operands(f, sim.tab_rhs.points, plan, cfg.r_c,
                                    cut, device)
        kw["n_out"] = f.n_cells + 1
        rows.append(kernel_row(
            "tile_density", A, lambda: td.tile_density(*args, **kw),
            lambda: td.tile_density_plain(*args, **kw),
            lambda out: roofline.tile_density(args, kw, out), 1e-5, device,
            same_zeros=True))
    return rows


def poisson7(side: int):
    """The 7-point Laplacian on a ``side``^3 grid as COO (rows, cols, vals
    float32, n): the matrix of ``tools/bench_kernels.py:build_poisson``."""
    n = side ** 3
    idx = np.arange(n).reshape(side, side, side)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [6.0 * np.ones(n)]
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [-np.ones(len(a)), -np.ones(len(a))]
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals).astype(np.float32), n)


def poisson_csr(side: int, device):
    """The 7-point matrix as ops/spmv.py:CSR with float32 data on
    ``device``."""
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    r, c, v, n = poisson7(side)
    order = np.lexsort((c, r))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return CSR.from_pattern(indptr, c[order], v[order], device=device)


def ell_rows(side: int, device) -> list:
    """The SpMV forms on the 7-point matrix, timed in turns."""
    import warnings
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops import ell
    A = poisson_csr(side, device)
    sl, vals = A.ell()
    pc, pv = sl.padded(vals)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.n_cols).astype(np.float32)).to(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # "CSR support is in beta"
        lib = torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr).to(device, torch.int32),
            torch.from_numpy(A.indices).to(device, torch.int32), A.data,
            size=(A.n_rows, A.n_cols))
    fns = {"ell_spmv": lambda: ell.ell_mv(sl, vals, x),
           "ell_spmv_padded": lambda: ell.ell_mv(pc, pv, x),
           "spmv_csr": lambda: A.matvec(x),
           "torch.mv": lambda: torch.mv(lib, x),
           "plain": lambda: ell.ell_mv_plain(sl, vals, x)}
    ref = fns["plain"]()
    errs = {k: _max_err(fns[k](), ref) for k in fns if k != "plain"}
    ran = {}
    t = samples_by_device(fns, device, ran=ran)
    ms = {k: float(np.median(v)) for k, v in t.items()}
    b = roofline.ell_spmv(sl, vals, x)
    rows = []
    for k in ("ell_spmv", "ell_spmv_padded", "spmv_csr"):
        err, ymax = errs[k]
        # one kernel a call: the check, and the calls that ran in the timing
        launches = 1 + ran[k] if device.type == "cuda" else 0
        rows.append(make_row(k, A.n_rows, ms[k], ms["plain"],
                             ms["torch.mv"], b, err, err <= 1e-6 * ymax,
                             launches, device))
    lib_err, ymax = errs["torch.mv"]
    if not lib_err <= 1e-6 * ymax:
        raise AssertionError(f"torch.mv on the CSR tensor: max err "
                             f"{lib_err:.3e}")
    return rows


def cg_rows(side: int, device) -> list:
    """Iterations per second of a hot Jacobi-CG and Chebyshev-CG solve on
    the 7-point matrix to ``1e-6 ||b||`` (the second of two solves, each
    stepped as the driver runs them: CUDA graphs on the card)."""
    from coulomb_gmg_tpu_torch.ops.smoothers import make_jacobi
    from coulomb_gmg_tpu_torch.solver.fused import SteppedCG
    from coulomb_gmg_tpu_torch.solver.tpu_cg import SteppedChebyCG
    A = poisson_csr(side, device)
    n_pad = A.n_rows + 1
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        A.n_rows).astype(np.float32)).to(device)
    bnorm = float(torch.linalg.vector_norm(b))
    tol = 1e-6 * bnorm
    jac = make_jacobi(A, 0.6)
    one = lambda f: (lambda v: [f(v[0])])
    jacobi = SteppedCG(one(A.matvec), one(jac),
                       lambda u, v: [torch.dot(u[0], v[0])],
                       lambda v: torch.linalg.vector_norm(v[0]), [b],
                       dealii=True)
    sl, vals = A.ell(n_pad)
    inv_diag = torch.ones(n_pad, dtype=torch.float32, device=device)
    inv_diag[: A.n_rows] = 1.0 / A.diagonal()
    cheb = SteppedChebyCG(sl, vals, inv_diag, device)
    b_pad = torch.cat([b, b.new_zeros(1)])
    solves = {"jacobi_cg": lambda: jacobi.solve([b], [torch.zeros_like(b)],
                                                tol, 2000),
              "chebyshev_cg": lambda: cheb.solve(b_pad,
                                                 torch.zeros_like(b_pad),
                                                 tol, 2000)}
    rows = []
    count = counters()["ell_spmv"]
    for name, solve in solves.items():
        solve()                                        # capture
        n0 = count.launches
        res, s = wall_s(solve, device)
        rows.append({"solver": name, "size": A.n_rows,
                     "iterations": res.iterations, "s": s,
                     "iters_per_s": res.iterations / s,
                     "rel_residual": res.final_residual / bnorm,
                     "converged": res.final_residual < tol,
                     "launches": count.launches - n0,
                     "device": device_name(device)})
    jacobi.release()
    cheb.release()
    return rows


def op_rates(device) -> list:
    """Rates of single torch elementwise ops on a (512, 4096) float32 tile
    (``tools/roofline.py:209-246``): per op a CUDA graph of n and of 2n
    chained in-place calls, the rate from the difference of their replay
    times; then the op-mix prediction of the density and gradient pair
    rates.  Each torch op is a kernel of its own that reads and writes the
    tile, so these rates bound what torch ops reach, not the ALUs'."""
    from coulomb_gmg_tpu_torch import roofline
    if device.type != "cuda":
        raise RuntimeError("op_rates: CUDA graphs need the card")
    tile = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 2.0, (512, 4096)).astype(np.float32)).to(device)
    a = torch.full_like(tile, -1e-4)
    ops = {"fma (x*a+b)": (lambda v: v.addcmul_(v, a), 2),
           "exp": (lambda v: v.exp_(), 1), "rsqrt": (lambda v: v.rsqrt_(), 1),
           "erf": (lambda v: v.erf_(), 1)}

    def replay_ms(fn, n):
        v = tile.clone()
        fn(v)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn(v)
        g.replay()
        return min(sample_ms(g.replay, 1) for _ in range(5))

    rows, rate = [], {}
    for name, (fn, flops) in ops.items():
        n = 256
        dt = replay_ms(fn, 2 * n) - replay_ms(fn, n)
        rate[name] = tile.numel() * n / (dt * 1e-3) / 1e9      # Gop/s
        rows.append({"op": name, "gops_per_s": rate[name],
                     "share_of_fp32_peak":
                         rate[name] * 1e9 * flops / roofline.PEAK_FP32,
                     "device": device_name(device)})
    fma, ex, rs, erf = (rate[k] for k in ops)
    rows.append({"model": "predicted_gpairs_from_op_mix",
                 "density": 1.0 / (6 / fma + 1 / ex),
                 "gradient": 1.0 / (8 / fma + 1 / ex + 1 / rs + 1 / erf),
                 "device": device_name(device)})
    return rows


def text(row: dict) -> str:
    """One row as a line of the human table."""
    if "kernel" in row:
        lib = (f", library {row['library_ms']:.4f}"
               if row["library_ms"] is not None else "")
        return (f"{row['kernel']:16s} {row['size']:>8d}  {row['ms']:9.4f} ms"
                f" (plain {row['plain_ms']:.4f}{lib}); bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{100 * row['share']:.1f}%; max|err| {row['max_err']:.3e} "
                f"{'pass' if row['pass'] else 'FAIL'}; "
                f"{row['launches']} launches")
    return json.dumps(row)


def main(argv=None) -> list:
    """Run every row; print them; returns them."""
    from coulomb_gmg_tpu_torch.device import resolve
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="512,2744,8000",
                    help="atom counts (8 n^3 each, for the tile plan)")
    ap.add_argument("--points", type=int, default=262144)
    ap.add_argument("--side", type=int, default=64,
                    help="grid side of the 7-point matrix (side^3 rows)")
    ap.add_argument("--op-rates", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(0)
    rows = []
    for part in (lambda: tile_rows(sizes, device),
                 lambda: dense_rows(sizes, args.points, device, rng),
                 lambda: gradient_rows(sizes, args.points, device, rng),
                 lambda: ell_rows(args.side, device),
                 lambda: cg_rows(args.side, device),
                 lambda: op_rates(device) if args.op_rates else []):
        for row in part():
            rows.append(row)
            print(json.dumps(row) if args.json else text(row), flush=True)
    return rows


if __name__ == "__main__":
    import sys
    sys.exit(0 if all(r.get("pass", True) for r in main()) else 1)
