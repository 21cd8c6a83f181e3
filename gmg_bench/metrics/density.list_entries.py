"""Millions of (cell, atom) entries a solve's locality density evaluates
on the card over its compact atom lists (the float64 route's density,
``ops/density.py:list_density``): the counter ``density_list_entries``.
None where the program counts none."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "density_list_entries")
    return None if v is None else v / 1e6
