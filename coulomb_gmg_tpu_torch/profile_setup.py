"""The "Setup system" stage split into its pieces, on the final mesh.

    python -m coulomb_gmg_tpu_torch.profile_setup [n] [--device cuda|cpu]

Counterpart of ``tools/profile_setup.py``: the float64 production run of
``8 n^3`` atoms (``production_scaling_config(n, dtype="float64")``, default
n = 10) reaches its final mesh on ``--device`` (the card unless ``--device
cpu``; without a card it raises), then the pieces of the stage run again,
cold, on that forest: the DoF numbering on the forest's device
(mesh/dofs.py: ``_cell_node_keys``, the sorted unique keys and inverse,
the node positions, ``_find_hanging``, ``_build_level``, ``build_dofs``;
the card is synchronized around each piece), then on the host the
constraints (fem/constraints.py, including the one host copy of the DoF
arrays) and the host assembly plan (fem/assembly.py: ``_expand_entries``,
``native.pattern``, ``build_plan``), then the plan that the single-device
run builds in its place on the forest's device (fem/card_assembly.py:
``plan``, with the load vector's runs).  One line a piece with its wall
seconds on the host clock, under the JAX tool's labels where the piece is
the same, and its last line: the pattern's nonzeros and the clean and
dirty counts.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def profile(f, degree: int, boundary_fn) -> dict:
    """Time the pieces on forest ``f``; returns ``{"seconds": {label: s},
    "nnz", "clean", "n_cells", "dirty_m"}``."""
    import torch
    from coulomb_gmg_tpu_torch.fem import card_assembly
    from coulomb_gmg_tpu_torch.fem.assembly import _expand_entries, build_plan
    from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
    from coulomb_gmg_tpu_torch.mesh.dofs import (_build_level,
                                                 _cell_node_keys,
                                                 _find_hanging, _index,
                                                 _numbering, build_dofs)
    from coulomb_gmg_tpu_torch.utils import native

    seconds = {}
    sync = ((lambda: torch.cuda.synchronize(f.device))
            if f.device.type == "cuda" else (lambda: None))

    def t(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        seconds[label.strip()] = dt = time.perf_counter() - t0
        print(f"{label:42s} {dt:8.2f} s", flush=True)
        return out

    p = degree
    ckeys = t("  _cell_node_keys", lambda: _cell_node_keys(f, p))
    num = t("  unique keys, inverse, boundary (cell2dof)",
            lambda: _numbering(f, ckeys, p))
    kidx = _index(num[0])
    t("  node positions", lambda: f.node_position(num[2], p))
    t("  _find_hanging", lambda: _find_hanging(f, kidx, p))
    t("  _build_level (all levels)",
      lambda: [_build_level(f, l, p) for l in range(f.n_levels)])
    f.__dict__.pop("level_cells", None)   # cached_property: measure cold
    dofs = t("build_dofs TOTAL (cold, incl. level_cells)",
             lambda: build_dofs(f, p))

    cons = t("build_constraints", lambda: build_constraints(dofs,
                                                            boundary_fn))
    c2d = dofs.cell2dof
    dofs = dofs.host
    crow = t("  row_of(cell2dof)", lambda: cons.row_of(
        dofs.cell2dof.reshape(-1)).reshape(dofs.cell2dof.shape))
    clean = ~(crow >= 0).any(axis=1)
    clean_idx = np.where(clean)[0]
    dirty_idx = np.where(~clean)[0]
    exp = t("  _expand_entries (dirty)", lambda: _expand_entries(
        dofs.cell2dof[dirty_idx], crow[dirty_idx], cons))
    m_row, m_col, d_dof = exp[4], exp[5], exp[8]
    n_basis = dofs.cell2dof.shape[1]
    t("  native.pattern", lambda: native.pattern(
        dofs.cell2dof[clean_idx].reshape(len(clean_idx), n_basis),
        np.concatenate([m_row, d_dof]), np.concatenate([m_col, d_dof]),
        cons.n_dofs))
    plan = t("build_plan TOTAL", lambda: build_plan(dofs.cell2dof, cons))
    t("card_assembly.plan TOTAL (forest's device)", lambda: card_assembly.plan(
        c2d, card_assembly.card_constraints(cons, f.device), rhs=True))
    print(f"pattern nnz: {plan.pattern.nnz}, "
          f"clean {len(plan.clean_idx)}/{plan.n_cells} cells, "
          f"dirty m-entries {len(plan.md_cell)}", flush=True)
    return {"seconds": seconds, "nnz": int(plan.pattern.nnz),
            "clean": len(plan.clean_idx), "n_cells": int(plan.n_cells),
            "dirty_m": len(plan.md_cell)}


def main(argv=None) -> dict:
    """Reach the final mesh and profile the stage there; returns
    :func:`profile`'s record with the run's final cell count."""
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.device import resolve
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=10,
                    help="8 n^3 atoms (default 10: 8,000)")
    ap.add_argument("--device", default="cuda",
                    help="device of the run to the final mesh (default the "
                         "card; cpu on request)")
    args = ap.parse_args(argv)
    cfg = production_scaling_config(args.n, dtype="float64")
    sim = Simulation(cfg, atoms=nacl_lattice(args.n),
                     device=resolve(args.device), pcout=Pcout(enabled=False))
    sim.run()
    f = sim.forest
    print(f"final mesh: {f.n_cells} cells", flush=True)
    return profile(f, cfg.degree, sim.boundary_fn())


if __name__ == "__main__":
    main()
