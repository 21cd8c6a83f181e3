"""Cells of every cycle but the last that the reference marks clearly above
its threshold, ``eta > theta (1 + DELTA)``, and that the next cycle did
not split (gmg_bench/checks/_marking.py); exact, limit 0."""

from gmg_bench.checks._marking import marking


def read(ctx):
    return marking(ctx)["missed"]
