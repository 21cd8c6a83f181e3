"""Host seconds of a solve's run in no child span: the self time of the
root span ``run``."""

from gmg_bench.metrics._spans import mean_span


def read(ctx):
    return mean_span(ctx, "run", key="self_s")
