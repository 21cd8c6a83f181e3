"""Seconds a solve spends on the volume term of the error indicator
(``adapt/estimator.py``, the span ``estimate.volume``), apart from the face
jumps."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "estimate.volume")
