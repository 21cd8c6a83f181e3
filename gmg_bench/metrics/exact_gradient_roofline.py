"""Percent of its roofline that the exact_gradient kernel reached over the
traced solve: the bounds of its launches
(gmg_bench/kernels/exact_gradient.py) over their device time."""

from gmg_bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "exact_gradient")
