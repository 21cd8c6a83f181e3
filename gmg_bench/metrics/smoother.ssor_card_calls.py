"""SSOR applications a solve makes on the card (the float64 route's GMG
smoother, ``ops/smoothers.py:CardSSOR``): the counter ``ssor_card_calls``.
None where the program counts none: the host smoother, or a program
without the card sweep."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    return mean_counter(ctx, "ssor_card_calls")
