"""Seconds a solve spends refining the mesh, transferring the solution and
handing atoms to children (the driver's "Refine, solution transfer ..."
stage)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Refine, solution transfer and sending atoms "
                           "list to child cells")
