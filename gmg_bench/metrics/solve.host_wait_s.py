"""Seconds a solve spends in blocking card-to-host reads inside its
"Solve" stages, the wait for the card included: the counter
``host_read_ns``."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "host_read_ns", stage="Solve")
    return None if v is None else v / 1e9
