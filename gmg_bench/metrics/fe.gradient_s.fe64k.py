"""Seconds a solve spends in the FE error's loop over the cells, the exact
gradient kernel's launches and the error's read included: the span
``fe.gradient`` (``postprocess/energy.py``)."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "fe.gradient")
