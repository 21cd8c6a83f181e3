"""The inputs of a run, made from ``--seed`` by one generator for every
configuration and traffic mix.

A configuration file holds the published study's settings
(``settings``: keys of the program's ``Config``), its lattice (``lattice``:
a rock-salt lattice of ``8 n^3`` atoms, charges +-1, spacing 0.5, box
``[0, n]^3``) and the active cells that the study published for each cycle
(``published_cells``).  A traffic file holds the mix: the settings it
overrides (``overrides``) and, where these change the meshes, the cells
published for it (``published_cells``: a list, or null where none are);
every solve lists the atoms in an order of its own, drawn from the seed,
as a LAMMPS file may list them in any order.
"""

from __future__ import annotations

import numpy as np
import torch


def settings(config: dict, traffic: dict) -> dict:
    """The run's settings: the configuration's, then the mix's."""
    return {**config["settings"], **traffic.get("overrides", {})}


def published_cells(config: dict, traffic: dict):
    """The active cells per cycle that a run is held to: the traffic's
    ``published_cells`` where it has the key (None: nothing published for
    this mix), else the configuration's."""
    if "published_cells" in traffic:
        return traffic["published_cells"]
    return config.get("published_cells")


def lattice(n: int):
    """(positions (8 n^3, 3) float64, charges (8 n^3,) float64): sites at
    ``(i, j, k) * 0.5`` for ``i, j, k`` in ``[0, 2n)``, charge +1 where
    ``i + j + k`` is even and -1 where it is odd."""
    side = 2 * n
    idx = np.indices((side, side, side)).reshape(3, -1).T
    charges = np.where(idx.sum(axis=1) % 2 == 0, 1.0, -1.0)
    return idx.astype(np.float64) * 0.5, charges


class Orders:
    """The atom order of each solve of a run: permutation ``i`` is the
    ``i``-th drawn from a generator seeded with the run's seed, the same
    for the same seed and the same for every configuration of a size."""

    def __init__(self, seed: int, n_atoms: int):
        self.gen = torch.Generator().manual_seed(int(seed) % (1 << 64))
        self.n = n_atoms

    def next(self) -> np.ndarray:
        return torch.randperm(self.n, generator=self.gen).numpy()


def sample_index(seed: int, n_solves: int) -> int:
    """The solve that the comparison samples, drawn from the seed."""
    gen = torch.Generator().manual_seed((int(seed) + 0x9E3779B97F4A7C15)
                                        % (1 << 64))
    return int(torch.randint(n_solves, (1,), generator=gen))
