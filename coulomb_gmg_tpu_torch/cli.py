"""Command-line entry point of the PyTorch port.

    python -m coulomb_gmg_tpu_torch.cli --production 10 --device cuda
    python -m coulomb_gmg_tpu_torch.cli examples/gaussian-charges.prm \
        --device cuda

``--production N`` runs the reference's published scaling study
(config.py:production_scaling_config) on the generated ``8 N^3``-atom NaCl
lattice.  A ``.prm`` file is parsed as by the JAX package's CLI (its
LAMMPS file name is relative to the working directory); settings outside
the ported slice raise NotImplementedError (see ROADMAP.md).  The
device defaults to the card and raises without one; ``--device cpu`` runs
the kernels' plain versions.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="PyTorch/CUDA GMG solver for long-range Coulomb "
                    "interactions of Gaussian-smeared charges")
    ap.add_argument("prm", nargs="?", help="deal.II-style .prm parameter file")
    ap.add_argument("--production", type=int, metavar="N",
                    help="the published scaling study on 8*N^3 NaCl atoms")
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda (default), cuda:0 or cpu")
    ap.add_argument("--cycles", type=int, default=None,
                    help="override number of adaptive cycles")
    args = ap.parse_args(argv)
    if (args.prm is None) == (args.production is None):
        ap.error("give either a .prm file or --production N")

    from coulomb_gmg_tpu_torch.config import load_prm, production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.driver import Simulation

    overrides = {"dtype": "float32"}
    if args.cycles is not None:
        overrides["n_adaptive_cycles"] = args.cycles
    if args.production is not None:
        cfg = production_scaling_config(args.production, **overrides)
        atoms = nacl_lattice(args.production)
    else:
        cfg = load_prm(args.prm, **overrides)
        atoms = None
    Simulation(cfg, atoms=atoms, device=args.device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
