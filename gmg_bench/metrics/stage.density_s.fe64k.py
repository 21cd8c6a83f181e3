"""``stage.density_s``, read the same way, in the default-run cell, where
the density sums every atom (the all-atom kernel, no locality plan)."""

from gmg_bench.cells import metric_reader

read = metric_reader("stage.density_s")
