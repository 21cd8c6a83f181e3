"""``|e_program - e_ref| / e_ref`` for the energy-norm FE error of one
cycle of the sampled solve, drawn from the seed: the program's
``energy_norm_error`` of that cycle against the plain float64 error of the
program's own solution on that cycle's mesh, the exact gradient summed
over every atom (gmg_bench/reference/fe_error.py).  None where the program
computed no FE error in that cycle."""

import torch

from gmg_bench.reference import fem
from gmg_bench.reference.fe_error import energy_norm_error


def cycle_of(seed: int, n_cycles: int) -> int:
    """The cycle compared, drawn from the seed."""
    gen = torch.Generator().manual_seed((int(seed) + 0x5DEECE66D) % (1 << 64))
    return int(torch.randint(n_cycles, (1,), generator=gen))


def read(ctx):
    snaps = ctx["snapshots"]
    snap = snaps[cycle_of(ctx["seed"], len(snaps))]
    e = snap.get("energy_norm_error")
    if e is None:
        return None
    reps, lower, h0 = fem.base_grid(ctx["settings"])
    mesh = fem.Mesh(reps, lower, h0, snap["level"], snap["ijk"],
                    ctx["device"])
    u, _ = fem.vertex_values(mesh, snap["positions"], snap["solution"])
    ref = energy_norm_error(mesh, u, ctx["positions"], ctx["charges"],
                            ctx["settings"]["r_c"])
    return abs(e - ref) / ref
