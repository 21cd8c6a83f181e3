"""``stage.estimate_s``, read the same way, in the default-run cell, where
the estimate adds the volume term."""

from gmg_bench.cells import metric_reader

read = metric_reader("stage.estimate_s")
