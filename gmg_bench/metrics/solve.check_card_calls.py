"""Solve checks a solve runs where the system lies (the true residual,
the norms and the distribution of the constrained rows in one pass with
one read, ``solver/check.py:card_check``): the counter
``check_card_calls``, one a cycle.  None where the program counts none: a
program whose check runs in host numpy."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    return mean_counter(ctx, "check_card_calls")
