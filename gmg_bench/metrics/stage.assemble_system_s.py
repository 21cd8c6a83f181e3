"""Seconds a solve spends assembling the system and its RHS (the driver's
"Assemble system" stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Assemble system")
