"""Seconds a solve spends in the Kelly estimate and the marking (the
driver's "Estimate error and mark cells" stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Estimate error and mark cells")
