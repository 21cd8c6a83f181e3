"""Atom dataset generators.

The reference ships NaCl-type rock-salt lattices as data files
(``atom/atom_n{N}_{8N^3}.data``): alternating +-1 charges on a cubic lattice
with spacing 0.5 in a box ``[0, N]^3`` (charge neutral).  We generate them
programmatically instead of shipping ~78k lines of data.
"""

from __future__ import annotations

import numpy as np

from coulomb_gmg_tpu_torch.io.lammps import AtomData


def nacl_lattice(n: int) -> AtomData:
    """Rock-salt lattice with ``8*n^3`` atoms.

    Sites at ``(i, j, k) * 0.5`` for ``i,j,k in [0, 2n)``; charge ``+1`` on
    even-parity sites, ``-1`` on odd (types 1/2), box ``[0, n]^3`` — matching
    the layout of the reference's ``atom/atom_n{n}_*.data`` files.
    """
    side = 2 * n
    idx = np.indices((side, side, side)).reshape(3, -1).T  # (8n^3, 3)
    parity = idx.sum(axis=1) % 2
    charges = np.where(parity == 0, 1.0, -1.0)
    types = np.where(parity == 0, 1, 2).astype(np.int32)
    positions = idx.astype(np.float64) * 0.5
    return AtomData(
        positions=positions, charges=charges, types=types,
        box_lo=np.zeros(3), box_hi=np.full(3, float(n)),
    )


def two_atom_pair() -> AtomData:
    """The 2-atom test case of the golden regression run
    (``tests/atom_n1_2.data``): +1 at origin, -1 at (0.5, 0, 0)."""
    return AtomData(
        positions=np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]),
        charges=np.array([1.0, -1.0]),
        types=np.array([1, 2], np.int32),
        box_lo=np.zeros(3), box_hi=np.ones(3),
    )
