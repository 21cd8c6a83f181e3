"""LAMMPS "full" atom-data file reader.

Token-position parser with the same semantics as the reference
(``src/step-50.cc:181-258``): whitespace token #2 is the atom count, and the
atom table starts at token #35 with rows ``id mol type q x y z``.  3D only;
a missing file is not an error — it selects the analytic-RHS path
(``lammpsinput = 0`` in the reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class AtomData:
    """Atom positions/charges. Empty (`n == 0`) means "no LAMMPS input"."""

    positions: np.ndarray   # (n, 3) float64
    charges: np.ndarray     # (n,) float64
    types: np.ndarray       # (n,) int32
    box_lo: np.ndarray      # (3,)
    box_hi: np.ndarray      # (3,)

    @property
    def n(self) -> int:
        return len(self.charges)

    @property
    def has_atoms(self) -> bool:
        return self.n > 0


def empty_atom_data() -> AtomData:
    z3 = np.zeros((0, 3))
    return AtomData(z3, np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(3), np.zeros(3))


def read_lammps_file(path: str, dim: int = 3) -> AtomData:
    """Read a LAMMPS data file; returns empty data if unopenable or dim != 3,
    mirroring the reference's fallback behavior (src/step-50.cc:246-256)."""
    if dim != 3 or not os.path.isfile(path):
        return AtomData(np.zeros((0, dim)), np.zeros(0),
                        np.zeros(0, np.int32), np.zeros(dim), np.zeros(dim))
    with open(path) as f:
        tokens = f.read().split()
    # Token layout of the "full" format the reference expects:
    #   [0]LAMMPS [1]Description [2]<n_atoms> atoms ... token 35+: atom rows.
    n_atoms = int(tokens[2])
    # Box bounds live at fixed positions in this layout: tokens 14..22 are
    # "xlo xhi xlo xhi ..." interleaved with labels; parse robustly instead.
    lo = np.zeros(3)
    hi = np.zeros(3)
    for i, ax in enumerate(("xlo", "ylo", "zlo")):
        try:
            j = tokens.index(ax)
            lo[i] = float(tokens[j - 2])
            hi[i] = float(tokens[j - 1])
        except (ValueError, IndexError):
            pass
    rows = tokens[35:35 + 7 * n_atoms]
    arr = np.array(rows, dtype=np.float64).reshape(n_atoms, 7)
    return AtomData(
        positions=arr[:, 4:7].copy(),
        charges=arr[:, 3].copy(),
        types=arr[:, 2].astype(np.int32),
        box_lo=lo, box_hi=hi,
    )


def write_lammps_file(path: str, atoms: AtomData) -> None:
    """Emit the same "full" layout so generated lattices round-trip through
    :func:`read_lammps_file` and through the reference parser."""
    n = atoms.n
    ntypes = int(atoms.types.max()) if n else 1
    if ntypes != 2:
        raise ValueError(
            "the fixed token-35 'full' layout requires exactly 2 atom types "
            "(2 Masses lines), like every reference data file")
    with open(path, "w") as f:
        f.write("LAMMPS Description\n\n")
        f.write(f"     {n}  atoms\n")
        f.write("     0  bonds\n     0  angles\n     0  dihedrals\n"
                "     0  impropers\n\n")
        f.write(f"     {ntypes}  atom types\n\n")
        for i, (a, b) in enumerate(zip("xyz", "xyz")):
            f.write(f"  {atoms.box_lo[i]:.1f} {atoms.box_hi[i]:.1f} "
                    f"{a}lo {b}hi\n")
        f.write("\nMasses\n\n")
        for t in range(1, ntypes + 1):
            f.write(f"      {t}\t\t1.0\n")
        f.write("\nAtoms # full\n\n")
        for i in range(n):
            p = atoms.positions[i]
            f.write(f"{i+1} {i+1} {atoms.types[i]} {atoms.charges[i]:.1f} "
                    f"{p[0]} {p[1]} {p[2]}\n")
