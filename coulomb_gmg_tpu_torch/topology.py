"""The adaptive cycle's topology for one refinement step, as one record.

``topology_outputs`` runs every torch function that derives the cycle's
topology from the forest (the DoF numbering with its hanging pairs and
level DoFs, ``level_cells``, the level topology and copy maps, the
covering map and solution transfer, the face plans, the Kelly estimate and
its marking) on the forests' device and gives their arrays by name.  Two
devices' records of the same inputs are compared array by array:
``chip_smoke.py`` phase 16 and ``tests/test_torch_cuda.py`` hold the
card's record to the CPU's.
"""

from __future__ import annotations

import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (
    build_face_plan, estimate, mark_cells, update_face_plan)
from coulomb_gmg_tpu_torch.adapt.transfer import (old_cell_of_new,
                                                  transfer_solution)
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.stencil import level_topology
from coulomb_gmg_tpu_torch.solver.device_gmg import copy_maps


def topology_outputs(old, new, u_old, u_new, degree: int = 1,
                     rho_q=None) -> dict:
    """Every topology function's output for one refinement step
    ``old`` -> ``new``, on ``new.device`` (pass both forests through
    ``Forest.on(device)``): the DoF numbering of ``new`` with its hanging
    pairs and level DoFs, ``level_cells``, the level topology and copy maps
    (degree 1), the covering map, the transferred ``u_old``, the face plan
    built and updated, the Kelly estimate of ``u_new`` (with the volume
    term when ``rho_q`` is given) and its marking.  Name -> tensor; of two
    devices' records of the same inputs the integer and boolean arrays are
    equal and the float64 ones agree to rel 1e-14."""
    out = {}
    d = new.dofs_of(degree)
    for name in ("keys", "cell2dof", "boundary", "positions"):
        out[name] = getattr(d, name)
    for name, t in zip(("rows", "cols", "weights"), d.hanging_pairs):
        out[f"hanging.{name}"] = t
    for ld in d.levels:
        for name in ("keys", "cell2dof", "active_index", "boundary",
                     "interface"):
            out[f"level{ld.level}.{name}"] = getattr(ld, name)
        ijk, act = new.level_cells[ld.level]
        out[f"level{ld.level}.ijk"], out[f"level{ld.level}.active"] = ijk, act
        if degree == 1:
            t = level_topology(new, ld, ld.level)
            for name in ("coords", "mask8", "elim", "iface", "boundary"):
                out[f"topology{ld.level}.{name}"] = getattr(t, name)
    if degree == 1:
        for l, (g, lv) in enumerate(copy_maps(new, d)):
            out[f"copy{l}.global"], out[f"copy{l}.level"] = g, lv
    omap = old_cell_of_new(old, new)
    out["old_cell_of_new"] = omap
    out["transfer"] = transfer_solution(old, new, u_old, degree, omap)
    built = build_face_plan(new)
    updated = update_face_plan(old, new, build_face_plan(old), omap)
    for name, v in vars(built).items():
        if isinstance(v, torch.Tensor):
            out[f"plan.{name}"] = v
            out[f"plan_updated.{name}"] = getattr(updated, name)
    tab = element_tables(new.dim, degree, degree + 1)
    err = estimate(new, d.cell2dof, u_new, rho_q, tab.points, tab.weights,
                   degree=degree, use_volume_term=rho_q is not None,
                   plan=updated)
    flags, thr = mark_cells(err)
    out["estimate"], out["flags"] = err, flags
    out["threshold"] = torch.tensor(thr, dtype=torch.float64,
                                    device=err.device)
    return out
