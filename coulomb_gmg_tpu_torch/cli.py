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
kernel; ``--no-fused-solve`` sets ``solve_fused = False``, as the JAX CLI
does: every device solve then runs its eager loop, one host read per CG
iteration, in place of the stepped solve of solver/fused.py; ``--profile
DIR`` writes a ``torch.profiler`` trace of the run to ``DIR/trace.json``
(Chrome / Perfetto format).

``--distributed`` joins a ``torch.distributed`` process group before the
run, from the environment that ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
utils/platform.py:init_distributed), as the JAX CLI calls
``jax.distributed.initialize``.  The device then defaults to
``cuda:LOCAL_RANK`` and the log prints on rank 0 only.  The backend is
``gloo`` for ``--device cpu`` and ``nccl`` on the cards, one card per rank
(more ranks than cards raise).  Each rank runs the configuration's
``Simulation``; ``n_devices > 1`` over several ranks raises, since the SPMD
pipeline runs in one process (the sharded solvers across processes:
``python -m coulomb_gmg_tpu_torch.parallel.multihost``).  With
``--profile`` each rank writes ``DIR/trace.rank<r>.json``::

    torchrun --nproc-per-node 2 -m coulomb_gmg_tpu_torch.cli \
        --production 10 --distributed
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
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cuda (default; cuda:LOCAL_RANK "
                         "with --distributed), cuda:0 or cpu")
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
    ap.add_argument("--no-fused-solve", action="store_true",
                    help="the eager solve loops instead of the stepped "
                         "solves (CUDA graphs on the card)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the run to "
                         "DIR/trace.json (Chrome/Perfetto format)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed process group from the "
                         "torchrun environment (MASTER_ADDR, MASTER_PORT, "
                         "RANK, WORLD_SIZE, LOCAL_RANK)")
    args = ap.parse_args(argv)
    if (args.prm is None) == (args.production is None):
        ap.error("give either a .prm file or --production N")

    if not args.distributed:
        return _run(args, args.device or "cuda", None, "trace.json")
    import torch
    import torch.distributed as dist
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    from coulomb_gmg_tpu_torch.utils.platform import init_distributed
    on_cpu = args.device is not None and torch.device(args.device).type \
        == "cpu"
    device = init_distributed(backend="gloo" if on_cpu else None,
                              device=args.device)
    rank = dist.get_rank()
    try:
        return _run(args, device, Pcout(enabled=rank == 0),
                    f"trace.rank{rank}.json")
    finally:
        dist.destroy_process_group()


def _run(args, device, pcout, trace_name) -> int:
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
    if args.no_fused_solve:
        overrides["solve_fused"] = False
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
    sim = Simulation(cfg, atoms=atoms, device=device, pcout=pcout)
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
    prof.export_chrome_trace(os.path.join(args.profile, trace_name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
