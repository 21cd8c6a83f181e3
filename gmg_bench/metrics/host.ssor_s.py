"""Host seconds a solve spends in the SSOR smoother's scipy triangular
solves, the span ``smoother.ssor_host``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "smoother.ssor_host")
