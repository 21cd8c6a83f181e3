"""Seconds a solve spends on the FE-error postprocess of every cycle (the
driver's "Postprocess FE error" stage: operands to the card, the exact
gradient kernel, the error's sum and read)."""

from gmg_bench.metrics._stages import mean_stage


def read(ctx):
    return mean_stage(ctx, "Postprocess FE error")
