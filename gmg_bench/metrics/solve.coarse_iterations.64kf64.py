"""Coarse CG iterations a solve makes, summed over its V-cycles: the
counter ``coarse_cg_iterations`` (``solver/multigrid.py:
GMGPreconditioner._coarse_solve``).  None where the program counts none."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    return mean_counter(ctx, "coarse_cg_iterations")
