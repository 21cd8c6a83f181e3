"""Cutoff study: the locality-optimised RHS against brute force.

    python -m coulomb_gmg_tpu_torch.rc_sweep [--out Plotting] [--reps 20]
        [--lo 2.0] [--hi 6.0] [--step 0.25] [--device cuda|cpu]

Counterpart of ``tools/rc_sweep.py``, the reference's
``tests_rhs_rc_variation`` study, the one it published besides the scaling
series: two atoms (``two_atom_pair``) in the domain [-2, 3]^3 of ``reps``^3
cells, the RHS assembled from the density over every atom (brute force)
and from the density over the atoms within ``cutoff * r_c`` of a cell's
vertices, for cutoffs ``lo .. hi`` in steps of ``step``.  For each cutoff
it prints and tabulates the absolute error of the RHS norms (L1, L2,
L-infinity) and of the integrated total charge, in the four ``.dat``
tables that ``tools/plots.py`` reads, laid out as the JAX script writes
them.  Users of the reference run it to pick the cutoff (3.5 in
production).

Everything is float64: the densities through
ops/density.py:compute_density on ``--device`` (the card unless
``--device cpu``; no card raises), never the float32 kernels, since the
study measures float64 differences down to 0; the assembly on the same
device (fem/card_assembly.py: ``plan``, ``assemble``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

R_C = 0.5
NORMS = ("L1", "L2", "LInfinity")


class Study:
    """The study's mesh, atoms and assembly plan on ``device``: ``reps``^3
    cells of [-2, 3]^3, the pair of ``two_atom_pair``."""

    def __init__(self, reps: int, device):
        from coulomb_gmg_tpu_torch.device import upload
        from coulomb_gmg_tpu_torch.fem import card_assembly
        from coulomb_gmg_tpu_torch.fem.constraints import build_constraints
        from coulomb_gmg_tpu_torch.mesh.forest import Forest
        from coulomb_gmg_tpu_torch.models.atoms import two_atom_pair
        from coulomb_gmg_tpu_torch.ops.q1 import element_tables
        self.device = device
        self.atoms = two_atom_pair()
        self.forest = f = Forest.uniform(3, reps, np.full(3, -2.0),
                                         5.0 / reps)
        self.plan = card_assembly.plan(
            f.dofs.cell2dof.to(device), card_assembly.card_constraints(
                build_constraints(f.dofs, None), device), rhs=True)
        self.tab_rhs = element_tables(3, 1, 5)
        self.h = f.cell_h()
        self.K = card_assembly.cell_matrices(element_tables(3, 1, 2),
                                             upload(self.h, device))

    def rhs(self, cutoff: float = None) -> tuple:
        """(rhs, integrated total charge, mask): the RHS from the density
        over the atoms within ``cutoff * r_c`` of each cell's vertices
        (``mask``), or over every atom (``cutoff`` None, ``mask`` None)."""
        import torch
        from coulomb_gmg_tpu_torch.device import upload
        from coulomb_gmg_tpu_torch.fem.card_assembly import assemble
        from coulomb_gmg_tpu_torch.fem.integrals import rhs_cells_np
        from coulomb_gmg_tpu_torch.ops.density import (atom_masks,
                                                       compute_density)
        f, at, tab = self.forest, self.atoms, self.tab_rhs
        mask = (None if cutoff is None else
                atom_masks(f, at.positions, float(cutoff) * R_C,
                           self.device))
        rho = compute_density(f, tab.points, at.positions, at.charges, R_C,
                              self.device, mask=mask,
                              dtype=torch.float64).cpu().numpy()
        _, rhs = assemble(self.plan, self.K, upload(
            rhs_cells_np(tab, self.h, rho), self.device))
        rhs = rhs.cpu().numpy()
        # integrated total charge: sum_cells vol * sum_q w_q rho_q / 4pi
        w = np.asarray(tab.weights)
        return rhs, float((self.h ** 3 * (rho @ w)).sum() / (4.0 * np.pi)), \
            mask


def _norms(rhs) -> dict:
    return {"L1": float(np.abs(rhs).sum()),
            "L2": float(np.linalg.norm(rhs)),
            "LInfinity": float(np.abs(rhs).max())}


def sweep(reps: int, lo: float, hi: float, step: float, device) -> list:
    """One row a cutoff: ``{"cutoff", "L1", "L2", "LInfinity",
    "charge"}``, each error absolute against the brute-force RHS."""
    study = Study(reps, device)
    rhs_ref, q_ref, _ = study.rhs()
    ref = _norms(rhs_ref)
    rows = []
    for c in np.arange(lo, hi + 1e-9, step):
        rhs, q, _ = study.rhs(c)
        got = _norms(rhs)
        rows.append({"cutoff": float(c),
                     **{k: abs(got[k] - ref[k]) for k in NORMS},
                     "charge": abs(q - q_ref)})
        print(f"cutoff {c:4.2f}  L2 err {rows[-1]['L2']:.12f}  "
              f"charge err {rows[-1]['charge']:.10f}", flush=True)
    return rows


def write_tables(rows: list, out: str) -> list:
    """The four ``.dat`` tables of ``tools/rc_sweep.py``, byte for byte
    in everything but the numbers; returns their paths."""
    os.makedirs(out, exist_ok=True)
    paths = []
    for norm in NORMS:
        path = os.path.join(out, f"RHS_Norm_value_comparison_{norm}.dat")
        with open(path, "w") as fh:
            fh.write(f"#RHS_Norm_value_comparison_{norm}.dat for {norm} "
                     "norm values\n")
            fh.write("#Here system_rhs vector norm values with and without "
                     "rhs assembly optimization are compared\n")
            fh.write("#Absolute error between these 2 norm values is "
                     "taken\n\n")
            fh.write(f"#rhs {norm} norm\nCutoff\tAbsErr{{{norm}}}\n")
            for r in rows:
                fh.write(f"{r['cutoff']:.2f}\t{r[norm]:.12f}\n")
        paths.append(path)
    path = os.path.join(out, "Total_charge_density_AbsErr_L2.dat")
    with open(path, "w") as fh:
        fh.write("\n#Total_charge_density_AbsErr_L2.dat\n")
        fh.write("#Here charge_densities integrated over the domain with "
                 "and without rhs assembly optimization are compared\n")
        fh.write("#Absolute error between these 2 values is taken\n\n")
        fh.write("#total charge density error\nCutoff\tAbsError{L2}\n")
        for r in rows:
            fh.write(f"{r['cutoff']:.2f}\t{r['charge']:.10f}\n")
    return paths + [path]


def main(argv=None) -> list:
    """Run the study and write its tables; returns the rows."""
    from coulomb_gmg_tpu_torch.device import resolve
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="Plotting")
    ap.add_argument("--reps", type=int, default=20,
                    help="base mesh cells per side (domain [-2, 3]^3)")
    ap.add_argument("--lo", type=float, default=2.0)
    ap.add_argument("--hi", type=float, default=6.0)
    ap.add_argument("--step", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    rows = sweep(args.reps, args.lo, args.hi, args.step, device)
    write_tables(rows, args.out)
    print(f"wrote 4 .dat tables to {args.out}/")
    return rows


if __name__ == "__main__":
    main()
