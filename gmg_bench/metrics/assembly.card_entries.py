"""Millions of matrix entries a solve enumerates, sorts and sums on the
card to build its CSR system, level and interface matrices (the float64
route's device assembly, ``fem/card_assembly.py``): the counter
``assembly_entries``.  None where the program counts none."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "assembly_entries")
    return None if v is None else v / 1e6
