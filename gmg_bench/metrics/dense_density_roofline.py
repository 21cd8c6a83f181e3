"""Percent of its roofline that the dense_density kernel reached over the
traced solve: the bounds of its launches
(gmg_bench/kernels/dense_density.py) over their device time."""

from gmg_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "dense_density")
