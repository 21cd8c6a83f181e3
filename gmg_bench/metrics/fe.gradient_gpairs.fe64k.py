"""Billions of (point, atom) pairs a solve's exact gradient evaluates, every
cycle's FE error: the counter ``gradient_pairs`` (``ops/gradient.py:
exact_gradient``).  None where the program counts none."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "gradient_pairs")
    return None if v is None else v / 1e9
