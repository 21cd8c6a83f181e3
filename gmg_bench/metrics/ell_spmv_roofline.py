"""Percent of its roofline that the ell_spmv kernel reached over the traced
solve: the bounds of its launches (gmg_bench/metrics/_roofline.py) over
their device time."""

from gmg_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "ell_spmv")
