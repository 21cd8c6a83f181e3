"""Seconds a solve spends building sliced ELL layouts on the host from the
card-built CSR matrices, the transposes' patterns with them: the span
``ell.host_build`` (``ops/spmv.py:CSR.ell``), the values' read-back
included.  None where the program opens no such span."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "ell.host_build")
