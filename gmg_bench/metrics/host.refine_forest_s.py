"""Host seconds a solve spends refining the forest (``Forest.refine``,
balance included), the span ``topology.refine``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "topology.refine")
