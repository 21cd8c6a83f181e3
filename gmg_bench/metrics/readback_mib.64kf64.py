"""MiB of matrix patterns and values a solve copies from the card to the
host for the host builds: the counter ``readback_bytes``
(``device.py:read_back``).  None where the program counts none."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "readback_bytes")
    return None if v is None else v / 2 ** 20
