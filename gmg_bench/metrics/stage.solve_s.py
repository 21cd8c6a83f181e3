"""Seconds a solve spends in GMG-CG, refinement passes and graph captures
included (the driver's "Solve" stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Solve")
