"""Seconds a solve spends making the stepped solves' CUDA graphs: the
warm-up, capture and instantiation of each cycle's graphs, the span
``graphs.capture``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "graphs.capture")
