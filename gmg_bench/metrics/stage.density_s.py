"""Seconds a solve spends on the charge density: the locality lists and the
density kernels (the driver's "RHS assembly optimization" and "Compute
charge densities" stages)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Compute charge densities",
                      "RHS assembly optimization")
