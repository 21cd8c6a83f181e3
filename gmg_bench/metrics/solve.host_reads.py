"""Blocking card-to-host reads a solve makes inside its "Solve" stages,
the counter ``host_reads``."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    return mean_counter(ctx, "host_reads", stage="Solve")
