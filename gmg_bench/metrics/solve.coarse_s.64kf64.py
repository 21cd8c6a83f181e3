"""Seconds a solve spends in the level-matrix GMG's coarse solves: the
unpreconditioned CG on level 0, the whole base mesh, to 1e-10, one host
read an iteration (the span ``solve.coarse``,
``solver/multigrid.py:GMGPreconditioner._coarse_solve``)."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "solve.coarse")
