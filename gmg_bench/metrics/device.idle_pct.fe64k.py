"""``device.idle_pct``, read the same way, in the default-run cell."""

from gmg_bench.cells import metric_reader

read = metric_reader("device.idle_pct")
