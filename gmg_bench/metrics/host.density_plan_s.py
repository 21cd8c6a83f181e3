"""Host seconds a solve spends planning the density: the tile plan
(``build_tile_plan``) or the locality lists and masks, the span
``density.plan``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "density.plan")
