"""Seconds a solve spends on the constraints and the assembly plan
(``build_constraints``, ``build_plan``), the span
``topology.constraints``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "topology.constraints")
