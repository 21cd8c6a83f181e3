"""Per-function seconds of the adaptive cycle's topology work.

    python -m coulomb_gmg_tpu_torch.profile_topology [--n 10] [--cycles 5]
        [--device cuda|cpu] [--out FILE]

Runs the production configuration of ``8 n^3`` atoms in float32
(``production_scaling_config(n)``: the main path's device-operator cycle,
as ``chip_smoke.py`` phase 4 and the bench's ``gpu`` configuration run it)
through ``Simulation`` on ``--device`` (the card unless ``--device cpu``) and
times every call of the topology functions inside each driver stage: the
forest's refinement, the DoF numbering (``build_dofs`` and its pieces),
the solution and locality transfer, the face plans, the Kelly estimate
and marking, the level topology and copy maps of the device GMG, the
constraints and the assembly plan.  Each timed call synchronizes the card
before and after, so its seconds include the device work it waits for;
nested calls are inclusive.  A function the loaded package lacks is
skipped, so the tool also profiles an older checkout of the package (run
it with that checkout first on ``sys.path``).

It prints the host first: CPU model, ``os.cpu_count()``, the affinity set,
the cgroup CPU quota, ``torch.get_num_threads()``, whether the native
engine loaded, and the seconds of a fixed single-threaded numpy sort
(4,194,304 random int64 keys, the size of an 8,000-atom cycle's node
keys) as a yardstick of the host's speed.  Then one line per cycle and
stage with its seconds and its functions', and as the last line one JSON
object with all of it (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from contextlib import contextmanager
from functools import wraps

import numpy as np

PKG = "coulomb_gmg_tpu_torch"
TARGETS = {
    "mesh.forest": ["Forest.refine", "Forest.balance_flags"],
    "mesh.dofs": ["build_dofs", "_cell_node_keys", "_find_hanging",
                  "_build_level"],
    "adapt.transfer": ["old_cell_of_new", "transfer_solution",
                       "transfer_cell_mask"],
    "adapt.estimator": ["build_face_plan", "update_face_plan", "estimate",
                        "mark_cells"],
    "ops.stencil": ["level_topology", "topology_signature"],
    "solver.device_gmg": ["copy_maps"],
    "fem.constraints": ["build_constraints"],
    "fem.card_assembly": ["plan"],
}


def host_info() -> dict:
    import torch
    model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            model = next((ln.split(":", 1)[1].strip() for ln in fh
                          if ln.startswith("model name")), "")
    except OSError:
        pass
    quota = None
    try:
        with open("/sys/fs/cgroup/cpu.max") as fh:
            quota = fh.read().strip()
    except OSError:
        pass
    native = None
    try:
        native = importlib.import_module(f"{PKG}.utils.native").available()
    except Exception as e:                       # noqa: BLE001
        native = f"error: {e}"
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 40, 1 << 22)
    t0 = time.perf_counter()
    np.sort(keys, kind="stable")
    sort_s = time.perf_counter() - t0
    return {"cpu": model, "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "cgroup_cpu_max": quota,
            "torch_threads": torch.get_num_threads(), "native": native,
            "numpy_sort_4M_s": sort_s, "package": os.path.dirname(
                importlib.import_module(PKG).__file__)}


def _install(device, table: dict, where: list):
    """Wrap every target where the package looks it up (module attributes
    that hold the same function, and class attributes)."""
    import sys
    import torch
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))

    def timed(name, fn):
        @wraps(fn)
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync()
                key = (where[0], where[1], name)
                s, c = table.get(key, (0.0, 0))
                table[key] = (s + time.perf_counter() - t0, c + 1)
        return run

    for mod_name, names in TARGETS.items():
        try:
            mod = importlib.import_module(f"{PKG}.{mod_name}")
        except ImportError:
            continue
        for name in names:
            if "." in name:
                cls_name, meth = name.split(".")
                cls = getattr(mod, cls_name, None)
                if cls is not None and meth in cls.__dict__:
                    setattr(cls, meth, timed(name, cls.__dict__[meth]))
                continue
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            w = timed(name, fn)
            for m in list(sys.modules.values()):
                if getattr(m, "__name__", "").startswith(PKG):
                    for attr, v in list(vars(m).items()):
                        if v is fn:
                            setattr(m, attr, w)


def run(n: int, cycles: int, device: str) -> dict:
    import torch
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout

    cfg = production_scaling_config(n, dtype="float32",
                                    n_adaptive_cycles=cycles)
    sim = Simulation(cfg, atoms=nacl_lattice(n), device=device,
                     pcout=Pcout(enabled=False))
    table, where = {}, [0, ""]
    _install(sim.device, table, where)
    orig = Simulation._stage

    @contextmanager
    def staged(self, name):
        prev = where[:]
        where[0], where[1] = len(self.results), name
        try:
            with orig(self, name):
                yield
        finally:
            where[:] = prev

    Simulation._stage = staged
    try:
        t0 = time.perf_counter()
        res = sim.run()
        wall = time.perf_counter() - t0
    finally:
        Simulation._stage = orig
    out = []
    for r in res:
        stages = {}
        for st, s in r["stages"].items():
            fns = {name: {"s": v[0], "calls": v[1]}
                   for (c, stage, name), v in table.items()
                   if c == r["cycle"] and stage == st}
            stages[st] = {"s": s, "functions": fns}
        out.append({"cycle": r["cycle"], "n_cells": r["n_cells"],
                    "cg": r["cg_iterations"], "stages": stages})
    return {"atoms": 8 * n ** 3, "dtype": "float32",
            "device": str(sim.device), "wall_s": wall, "cycles": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from coulomb_gmg_tpu_torch.device import resolve
    resolve(args.device)                   # the card, or raise before work
    info = host_info()
    print("[host] " + " ".join(f"{k}={v}" for k, v in info.items()),
          flush=True)
    rec = run(args.n, args.cycles, args.device)
    for c in rec["cycles"]:
        for st, v in c["stages"].items():
            fns = " | ".join(
                f"{k} {f['s']:.3f} ({f['calls']})"
                for k, f in sorted(v["functions"].items(),
                                   key=lambda kv: -kv[1]["s"]))
            print(f"[cycle {c['cycle']}] {st.split(',')[0]}: {v['s']:.3f} s"
                  + (f"; {fns}" if fns else ""), flush=True)
    print(f"[wall] {rec['wall_s']:.2f} s, {rec['atoms']} atoms on "
          f"{rec['device']}", flush=True)
    rec["host"] = info
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rec, fh)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
