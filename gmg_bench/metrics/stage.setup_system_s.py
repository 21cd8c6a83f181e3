"""Seconds a solve spends numbering DoFs and building the constraints and
assembly plans (the driver's "Setup system" stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Setup system")
