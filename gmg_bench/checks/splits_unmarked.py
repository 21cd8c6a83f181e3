"""Cells of every cycle but the last that the next cycle split, although
they lie below ``theta (1 - DELTA)`` and the reference's balance closure of
its marks does not split them (gmg_bench/checks/_marking.py); exact,
limit 0."""

from gmg_bench.checks._marking import marking


def read(ctx):
    return marking(ctx)["unmarked"]
