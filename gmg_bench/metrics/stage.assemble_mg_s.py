"""Seconds a solve spends building the multigrid levels and operators (the
driver's "Assemble Multigrid" stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Assemble Multigrid")
