"""Command-line entry point of the PyTorch port.

    python -m coulomb_gmg_tpu_torch.cli --production 10 --device cuda
    python -m coulomb_gmg_tpu_torch.cli examples/gaussian-charges.prm \
        --device cuda
    python -m coulomb_gmg_tpu_torch.cli examples/step-16.prm --float64

``--production N`` runs the reference's published scaling study
(config.py:production_scaling_config) on the generated ``8 N^3``-atom NaCl
lattice.  A ``.prm`` file is parsed as by the JAX package's CLI (its
LAMMPS file name is relative to the working directory).  Runs are float32
with the multicolour SSOR smoother unless ``--float64`` asks for the
reference's precision with the ``.prm``'s own smoother (the precision half
of the JAX CLI's ``--cpu`` golden-parity mode), on whatever device
``--device`` names; ``--smoother`` overrides the smoother.  The device
defaults to the card and raises without one; ``--device cpu`` runs the
kernels' plain versions.  Nothing falls back to the CPU.
``--no-density-tiles`` takes the mask or list density instead of the tile
kernel; ``--profile DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json`` (Chrome / Perfetto format).
"""

from __future__ import annotations

import argparse
import os
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
    ap.add_argument("--float64", action="store_true",
                    help="float64 with the .prm's own smoother "
                         "(golden-parity precision)")
    ap.add_argument("--smoother", default=None,
                    choices=["ssor", "mc_ssor", "jacobi", "chebyshev"])
    ap.add_argument("--no-density-tiles", action="store_true",
                    help="the mask or list density instead of the tile "
                         "kernel")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the run to "
                         "DIR/trace.json (Chrome/Perfetto format)")
    args = ap.parse_args(argv)
    if (args.prm is None) == (args.production is None):
        ap.error("give either a .prm file or --production N")

    from coulomb_gmg_tpu_torch.config import load_prm, production_scaling_config
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.driver import Simulation

    overrides = {}
    if args.cycles is not None:
        overrides["n_adaptive_cycles"] = args.cycles
    if args.smoother is not None:
        overrides["smoother"] = args.smoother
    if args.no_density_tiles:
        overrides["density_tiles"] = False
    if args.float64:
        overrides["dtype"] = "float64"
    else:
        overrides["dtype"] = "float32"
        overrides.setdefault("smoother", "mc_ssor")
    if args.production is not None:
        cfg = production_scaling_config(args.production, **overrides)
        atoms = nacl_lattice(args.production)
    else:
        cfg = load_prm(args.prm, **overrides)
        atoms = None
    sim = Simulation(cfg, atoms=atoms, device=args.device)
    if not args.profile:
        sim.run()
        return 0
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if sim.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sim.run()
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
