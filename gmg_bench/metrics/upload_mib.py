"""MiB a solve copies from host arrays to the card, every stage: the
counter ``upload_bytes`` (``device.py:upload``)."""

from gmg_bench.metrics._spans import mean_counter


def read(ctx):
    v = mean_counter(ctx, "upload_bytes")
    return None if v is None else v / 2 ** 20
