"""Profile of the PyTorch port's three 8k paths on one CUDA card.

    python -m coulomb_gmg_tpu_torch.measure [--out FILE]

The three 8,000-atom runs of ``chip_smoke.py`` (the production run; the
same lattice with the brute-force density and the FE error; the
host-assembled float64 run), each after a warm-up run on 8 atoms, once
untraced and once under ``torch.profiler``:
wall, stage seconds, device busy share, device time by kernel and, for each
hand kernel, the launches and device time of each of its device functions
(template instances, the dense density's pre-pass), beside the launches
that its wrapper counted in the traced run (``counted``).  Prints
one line per path and writes them all as JSON to ``--out`` (default
``build/measure.json``).  Needs a CUDA card.  Kernel times against their
plain versions and their bounds are ``chip_smoke.py``'s phase 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.density import dense_density
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient
from coulomb_gmg_tpu_torch.ops.tile_density import tile_density
from coulomb_gmg_tpu_torch.utils.logging import Pcout

ATOMS_N = 10                      # 8 * 10^3 = 8,000 atoms
# the hand kernels' device functions (csrc/), by the name of their source
HAND = {"tile_density": ("tile_density_kernel",),
        "ell_spmv": ("ell_spmv_kernel", "ell_sliced_kernel"),
        "dense_density": ("dense_density_kernel", "group_boxes_kernel"),
        "exact_gradient": ("exact_gradient_kernel",)}
# each hand kernel's wrapper, whose ``launches`` counts its launches
WRAPPERS = {"tile_density": tile_density, "ell_spmv": ell_mv,
            "dense_density": dense_density, "exact_gradient": exact_gradient}


def _run(n, flags):
    cfg = production_scaling_config(n, **{"dtype": "float32", **flags})
    sim = Simulation(cfg, atoms=nacl_lattice(n), device="cuda",
                     pcout=Pcout(enabled=False))
    before = {k: fn.launches for k, fn in WRAPPERS.items()}
    t0 = time.time()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counted = {k: fn.launches - before[k] for k, fn in WRAPPERS.items()}
    stages = {}
    for c in res:
        for k, v in c["stages"].items():
            stages[k] = stages.get(k, 0.0) + v
    return {"wall_s": wall, "cells": [c["n_cells"] for c in res],
            "cg": [c["cg_iterations"] for c in res], "stages_s": stages,
            "counted": counted}


def profile_paths() -> dict:
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, flags in (("8k", {}),
                        ("8k defaults", dict(flag_rhs_assembly=False,
                                             flag_postprocess_error=True)),
                        ("8k float64 host", dict(dtype="float64",
                                                 device_operators="off"))):
        _run(1, flags)                                  # warm-up
        untraced = _run(ATOMS_N, flags)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = _run(ATOMS_N, flags)
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
        hand = {kern: {"counted": traced["counted"][kern], "trace": [
                    {"name": e.key[:90], "count": e.count,
                     "ms": e.self_device_time_total / 1e3}
                    for e in dev if any(fn in e.key for fn in fns)]}
                for kern, fns in HAND.items()}
        r = {"untraced": untraced, "traced_wall_s": traced["wall_s"],
             "device_busy_ms": busy_ms,
             "device_busy_share": busy_ms / (1e3 * traced["wall_s"]),
             "hand_kernels": hand,
             "device_items": [{"name": e.key[:90], "count": e.count,
                               "ms": e.self_device_time_total / 1e3}
                              for e in top]}
        out[name] = r
        print(f"[profile {name}] {json.dumps(r)}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "measure.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {smi}", flush=True)
    res = {"device": smi, "profile": profile_paths()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
