"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require a CUDA card; print the nvidia-smi name and power limit;
2. build: compile both hand kernels (coulomb_gmg_tpu_torch/csrc) with nvcc;
3. kernel vs plain PyTorch version on the card, at main-path shapes (the
   8,000-atom cycle-0 density plan and finest level operator), with CUDA
   event timings;
4. main path: the 8,000-atom production run (5 adaptive cycles) through
   ``Simulation``; the published per-cycle cell counts must come out
   exactly, every cycle must reach a true float64 residual of
   1e-8 * ||b||, and both kernels must have been launched by that run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ATOMS_N = 10                       # 8 * 10^3 = 8,000 atoms
REF_CELLS = [512000, 512560, 523592, 543024, 576428]   # bench.py:65-72
REPS = 20


def median_ms(fn, reps=REPS):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    from coulomb_gmg_tpu_torch import kernels
    for name in ("ell_spmv", "tile_density"):
        t0 = time.time()
        kernels.build(name)
        ptxas = [ln.strip() for ln in
                 kernels.BUILD_LOG.get(name, {}).get("ptxas", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {time.time() - t0:.2f} s; "
              + " | ".join(ptxas), flush=True)


def phase_kernels():
    import torch
    from coulomb_gmg_tpu.config import production_scaling_config
    from coulomb_gmg_tpu.models.atoms import nacl_lattice
    from coulomb_gmg_tpu.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.ops import ell, tile_density as td
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
    print(f"[kernel] tile_density: {len(plan.atile)} items, {plan.nb} blocks;"
          f" max|err| {err_td:.3e} (max|rho| {scale:.3e}); kernel "
          f"{ms_td:.3f} ms, plain {ms_td_plain:.3f} ms", flush=True)

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
    ms_ell = median_ms(lambda: ell.ell_mv_cuda(cols, vals, x32))
    ms_ell_plain = median_ms(lambda: ell.ell_mv_plain(cols, vals, x32))
    print(f"[kernel] ell_spmv: K={cols.shape[0]} rows={cols.shape[1]}; max|err|"
          f" f32 {errs[torch.float32]:.3e} f64 {errs[torch.float64]:.3e}; "
          f"kernel {ms_ell:.4f} ms, plain {ms_ell_plain:.4f} ms", flush=True)
    return {
        "tile_density": dict(max_abs_err=err_td, ms=ms_td,
                             plain_ms=ms_td_plain),
        "ell_spmv": dict(max_abs_err=errs[torch.float32], ms=ms_ell,
                         plain_ms=ms_ell_plain),
    }


def phase_main_path():
    import torch
    from coulomb_gmg_tpu.config import production_scaling_config
    from coulomb_gmg_tpu.models.atoms import nacl_lattice
    from coulomb_gmg_tpu.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.ops.tile_density import tile_density

    cfg = production_scaling_config(ATOMS_N, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(ATOMS_N), device="cuda",
                     pcout=Pcout(enabled=False))
    ell_mv.launches = 0
    tile_density.launches = 0
    t0 = time.time()
    res = sim.run()
    wall = time.time() - t0
    launches = {"ell_spmv": ell_mv.launches,
                "tile_density": tile_density.launches}
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
    for r in res:
        if not r["residual"] <= 1.01e-8 * r["l2_rhs"]:
            raise AssertionError(f"cycle {r['cycle']}: residual "
                                 f"{r['residual']:.3e} > 1.01e-8 * |b|")
        if not 1 <= r["cg_iterations"] <= 20:
            raise AssertionError(f"cycle {r['cycle']}: CG "
                                 f"{r['cg_iterations']} outside [1, 20]")
    if not np.isfinite(sim.solution).all():
        raise AssertionError("non-finite solution")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
    return launches


def main():
    smi = phase_device()
    import torch
    phase_build()
    timing = phase_kernels()
    launches = phase_main_path()
    rec = {"kernels": [
        {"name": "tile_density", "route": "cuda",
         "source": "coulomb_gmg_tpu_torch/csrc/tile_density.cu",
         "replaces": "coulomb_gmg_tpu/ops/tile_density.py:179",
         "launches": launches["tile_density"], **timing["tile_density"]},
        {"name": "ell_spmv", "route": "cuda",
         "source": "coulomb_gmg_tpu_torch/csrc/ell_spmv.cu",
         "replaces": "coulomb_gmg_tpu/ops/ell.py:117",
         "launches": launches["ell_spmv"], **timing["ell_spmv"]},
    ]}
    print(smi)
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
