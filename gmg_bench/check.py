"""The comparison that decides ``correct``.

The window's solves each pass the program's own gate or count as failed
(:func:`solve_failures`).  One solve, drawn from the seed, keeps what it
produced in every cycle: the active cells ``(level, ijk)`` and the
solution at its DoF positions.  Once the window has closed, the peak
memory has been read and the program's state is freed, :func:`compare`
holds it to the plain reference (gmg_bench/reference/), cycle by cycle:

* ``mesh_faults``: cycle 0 is the base grid, every later mesh covers the
  box once and each of its cells is a cell of the mesh before or a child
  of one; exact, limit 0;
* ``cells_off_published``: cycles whose active cells differ in number from
  the published study's, where the traffic keeps the published settings;
  exact, limit 0;
* ``dof_mismatch``: solution positions that are no vertex of the mesh,
  plus vertices with no value or more than one; exact, limit 0;
* ``residual_max``: the largest relative residual of the reference's
  float64 system at the program's solution over the cycles; its limit is
  the cell's (``gmg_bench/limits/<cell>.json``), set from the readings of
  the program and of the control (gmg_bench/control.py).

The reference follows the program step by step: it rebuilds each cycle's
space, density, load and boundary values from the program's mesh of that
cycle, and does not redo the Kelly estimate that chose the mesh; the
published cell counts and the nesting hold the meshes themselves.
"""

from __future__ import annotations

import torch

from gmg_bench.reference import fem
from gmg_bench.reference.density import member_table

EXACT = ("mesh_faults", "cells_off_published", "dof_mismatch",
         "failed_solves")


def solve_failures(rec: dict, settings: dict, published) -> list:
    """Why one solve of the window missed the published accuracy: a
    cycle's true residual, as the program reports it, above
    ``1.01 cg_rtol ||b||``, or cells other than the published ones."""
    why = []
    tol = 1.01 * settings["cg_rtol"]
    for c, r in enumerate(rec["residual"]):
        if not r <= tol:
            why.append(f"cycle {c}: residual {r} ||b|| > {tol} ||b||")
    if published is not None and rec["cells"] != published:
        why.append(f"cells {rec['cells']} != published {published}")
    return why


def _cell_keys(level: torch.Tensor, ijk: torch.Tensor, reps: int):
    side = reps << 8
    return ((level * side + ijk[:, 0]) * side + ijk[:, 1]) * side + ijk[:, 2]


def mesh_faults(reps: int, meshes: list, device) -> int:
    """Cells that break the nesting of the cycles' meshes, plus meshes
    that do not cover the box once."""
    faults, prev = 0, None
    for level, ijk in meshes:
        lv = torch.as_tensor(level, device=device).to(torch.int64)
        ijk = torch.as_tensor(ijk, device=device).to(torch.int64)
        L = int(lv.max())
        scale = torch.ones_like(lv) << (L - lv)
        inside = ((ijk >= 0) & (ijk < (reps << lv)[:, None])).all(-1)
        faults += int((~inside).sum())
        keys = _cell_keys(lv, ijk, reps)
        if torch.unique(keys).numel() != keys.numel() or \
                int((scale ** 3).sum()) != (reps << L) ** 3:
            faults += 1
        if prev is None:
            faults += int((lv != 0).sum())
        else:
            parent = _cell_keys((lv - 1).clamp(min=0), ijk >> 1, reps)
            kept = torch.isin(keys, prev)
            split = (lv > 0) & torch.isin(parent, prev)
            faults += int((~(kept | split)).sum())
        prev = keys
    return faults


def compare(snaps: list, pos, q, settings: dict, published, limits: dict,
            failed: int, device) -> tuple:
    """(checks ``{name: {"value", "limit"}}``, correct) for the sampled
    solve's per-cycle snapshots ``snaps`` (dicts of ``level``, ``ijk``,
    ``positions``, ``solution``) on atoms ``pos``, ``q``."""
    dev = torch.device(device)
    reps, lower, h0 = fem.base_grid(settings)
    P = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    Q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    r_c = settings["r_c"]
    cut = settings["nonzero_radius"] * r_c
    members = member_table(reps, lower, h0, P, cut)
    worst, mismatch = 0.0, 0
    for s in snaps:
        mesh = fem.Mesh(reps, lower, h0, s["level"], s["ijk"], dev)
        u, miss = fem.vertex_values(mesh, s["positions"], s["solution"])
        mismatch += miss
        F, ug = fem.system_parts(mesh, P, Q, r_c, cut, members)
        r = fem.residual(mesh, F, ug, u)
        worst = max(worst, r) if r == r else float("inf")
        del mesh, u, F, ug
    cells = [len(s["level"]) for s in snaps]
    off = (sum(a != b for a, b in zip(cells, published))
           + abs(len(cells) - len(published))) if published else 0
    values = {
        "residual_max": worst,
        "mesh_faults": mesh_faults(reps, [(s["level"], s["ijk"])
                                          for s in snaps], dev),
        "cells_off_published": off,
        "dof_mismatch": mismatch,
        "failed_solves": failed,
    }
    checks = {k: {"value": v, "limit": limits[k] if k not in EXACT else 0}
              for k, v in values.items()}
    correct = bool(snaps) and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return checks, correct
