"""Checkpoint / resume for the adaptive pipeline.

The reference has NO cross-run persistence (SURVEY §5.4: a PBS walltime
kill loses the whole 5h+ run; `Plotting/RELEASE_atoms_Vs_walltime.dat:9`
records an 86,400 s timeout).  Here every adaptive cycle can snapshot the
complete resumable state — mesh topology (level/ijk arrays), the
constraint-distributed solution, the atom-locality state (the compact
lists' ``ptr``, ``atoms`` and ``home``, and beside them the JAX driver's
form: a dense ``mask`` up to 64 atoms, padded ``lists`` above), and the
cycle counter — as one compressed npz; a fresh process of either package
resumes at the next cycle.  Everything else (DoFs, constraints, operators)
is deterministic re-derivation from that state.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_checkpoint(path: str, sim, cycle: int) -> str:
    """Write the cycle snapshot; returns the file path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = sim.forest
    payload = dict(
        cycle=np.asarray(cycle),
        dim=np.asarray(f.dim),
        base_reps=np.asarray(f.base_reps),
        lower=np.asarray(f.lower),
        h0=np.asarray(f.h0),
        level=np.asarray(f.level),
        ijk=np.asarray(f.ijk),
        solution=np.asarray(sim.solution),
        flags=np.asarray(sim.flags),
    )
    lists = sim.lists
    if lists is not None:
        payload.update(lists_ptr=lists.ptr, lists_atoms=lists.atoms,
                       lists_home=lists.home)
        n_atoms = sim.atoms.n
        if n_atoms > 64:
            payload["lists"] = lists.padded()
        else:
            payload["mask"] = lists.mask(n_atoms)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """Returns (forest, solution, flags, lists, cycle); ``lists`` an
    ``AtomLists`` (None without locality), also from a snapshot of the JAX
    driver or an older one, which holds padded ``lists`` or a ``mask``."""
    from coulomb_gmg_tpu_torch.mesh.forest import Forest
    from coulomb_gmg_tpu_torch.ops.neighbors import AtomLists
    with np.load(path, allow_pickle=False) as z:
        f = Forest(dim=int(z["dim"]), base_reps=int(z["base_reps"]),
                   lower=z["lower"], h0=float(z["h0"]),
                   level=z["level"], ijk=z["ijk"])
        lists = None
        if "lists_ptr" in z:
            lists = AtomLists(z["lists_ptr"], z["lists_atoms"],
                              z["lists_home"])
        elif "lists" in z:
            lists = AtomLists.from_padded(z["lists"])
        elif "mask" in z:
            lists = AtomLists.from_mask(z["mask"])
        return f, z["solution"], z["flags"], lists, int(z["cycle"])
