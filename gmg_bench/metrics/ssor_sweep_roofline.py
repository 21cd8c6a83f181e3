"""Percent of its roofline that the SSOR sweep kernel reached over the
traced solve: the bounds of its launches (gmg_bench/kernels/ssor_sweep.py)
over their device time.  The sweep's dependency chain binds it, not its
bytes, so it reads low."""

from gmg_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "ssor_sweep")
