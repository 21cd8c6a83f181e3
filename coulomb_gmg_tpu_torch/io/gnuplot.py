"""Gnuplot grid-debug output (2D).

TPU-native re-implementation of ``grid_output_debug``
(src/step-50.cc:310-375): two self-contained gnuplot scripts per cycle —
cell outlines with the per-cell atom-index list as labels, and the same
grid with a 0/1 atom-presence flag per cell.  File naming follows the
reference: ``grid{dim}_p_cycle{cycle}{rank}.gp`` and
``grid_atom_presence{dim}_p_cycle{cycle}{rank}.gp``.
"""

from __future__ import annotations

import os

import numpy as np


_HEADER = (
    'set terminal png size 400,410 enhanced font "Helvetica,8"\n'
    'set output "{base}.png"\n'
    "set size square\n"
    "set view equal xy\n"
    "unset xtics\n"
    "unset ytics\n"
    "plot '-' using 1:2 with lines notitle, "
    "'-' with labels point pt 2 offset 1,1 notitle\n")


def _write_grid_outline(f, forest):
    """Cell outlines in gnuplot 'lines' format (blank-line separated loops) —
    the analogue of ``GridOut::write_gnuplot``."""
    lower = forest.cell_lower()
    h = forest.cell_h()
    for (x0, y0), hh in zip(lower, h):
        f.write(f"{x0} {y0}\n{x0 + hh} {y0}\n{x0 + hh} {y0 + hh}\n"
                f"{x0} {y0 + hh}\n{x0} {y0}\n\n")


def grid_output_debug(forest, mask, cycle: int, dim: int,
                      output_dir: str = ".", rank: int = 0):
    """Write the two debug scripts for one adaptive cycle.

    ``mask``: (n_cells, n_atoms) bool locality mask (or None -> empty
    lists, matching the reference when the optimization is off)."""
    centers = forest.cell_lower() + 0.5 * forest.cell_h()[:, None]

    base = f"grid{dim}_p_cycle{cycle}{rank}"
    with open(os.path.join(output_dir, base + ".gp"), "w") as f:
        f.write(_HEADER.format(base=base))
        _write_grid_outline(f, forest)
        f.write("e\n")
        if mask is not None:
            for c in range(forest.n_cells):
                atoms = np.where(mask[c])[0]
                lbl = "".join(f"{a}, " for a in atoms)
                f.write(f"{centers[c, 0]} {centers[c, 1]} \"{lbl}\"\n")
        f.write("e\n")

    base2 = f"grid_atom_presence{dim}_p_cycle{cycle}{rank}"
    with open(os.path.join(output_dir, base2 + ".gp"), "w") as f:
        f.write(_HEADER.format(base=base2))
        _write_grid_outline(f, forest)
        f.write("e\n")
        if mask is not None:
            for c in range(forest.n_cells):
                flag = 1 if mask[c].any() else 0
                f.write(f"{centers[c, 0]} {centers[c, 1]} \"{flag}\"\n")
        f.write("e\n")
