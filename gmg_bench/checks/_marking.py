"""The reference's indicator and marking of the sampled solve, shared by
the checks that read them (``threshold_rel``, ``marks_missed``,
``splits_unmarked``) and computed once a comparison (kept in its ``ctx``).

For each cycle, on that cycle's mesh (gmg_bench/reference/fem.py) and the
program's solution at its vertices: the reference density (the cut of
gmg_bench/check.py:density_cut, every atom that adds to a float64 sum
where the configuration sums every atom), the indicator and the threshold
of gmg_bench/reference/kelly.py.  Between one cycle and the next, the
cells that the program split, set against the reference's marks with the
band ``DELTA`` about the threshold:

* ``missed``: cells with ``eta > theta (1 + DELTA)`` that the next cycle
  did not split;
* ``unmarked``: cells that the next cycle split although the balance
  closure of the reference's marks at ``eta > theta (1 - DELTA)`` does not
  hold them.

``DELTA`` is the band within which the program's float32 density (in the
volume term) may put a cell on either side of the threshold; its readings
are in the cell's limits file."""

from __future__ import annotations

import torch

from gmg_bench.check import density_cut
from gmg_bench.reference import fem, kelly
from gmg_bench.reference.density import density_at, member_table

DELTA = 1e-3


def marking(ctx: dict) -> dict:
    """``{"theta_ref": [...], "theta": [...], "missed": n, "unmarked":
    n}`` of the sampled solve, computed once for ``ctx``."""
    if "_marking" in ctx:
        return ctx["_marking"]
    s, snaps = ctx["settings"], ctx["snapshots"]
    dev = torch.device(ctx["device"])
    reps, lower, h0 = fem.base_grid(s)
    P = torch.as_tensor(ctx["positions"], dtype=torch.float64, device=dev)
    Q = torch.as_tensor(ctx["charges"], dtype=torch.float64, device=dev)
    members = member_table(reps, lower, h0, P, density_cut(s, h0))
    out = {"theta_ref": [], "theta": [], "missed": 0, "unmarked": 0}
    for c, snap in enumerate(snaps):
        mesh = fem.Mesh(reps, lower, h0, snap["level"], snap["ijk"], dev)
        u, _ = fem.vertex_values(mesh, snap["positions"], snap["solution"])
        rho = density_at(mesh, members, P, Q, s["r_c"])
        eta = kelly.indicator(mesh, u, rho, s["estimator_volume_term"])
        theta = s["refine_fraction_of_max"] * float(eta.max())
        out["theta_ref"].append(theta)
        out["theta"].append(snap.get("threshold"))
        if c + 1 < len(snaps):
            nxt = snaps[c + 1]
            split = kelly.split_cells(snap["level"], snap["ijk"],
                                      nxt["level"], nxt["ijk"], reps, dev)
            out["missed"] += int(((eta > theta * (1 + DELTA))
                                  & ~split).sum())
            held = kelly.balance_closure(mesh, eta > theta * (1 - DELTA))
            out["unmarked"] += int((split & ~held).sum())
        del mesh, u, rho, eta
    ctx["_marking"] = out
    return out
