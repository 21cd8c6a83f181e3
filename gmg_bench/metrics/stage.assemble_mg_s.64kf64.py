"""``stage.assemble_mg_s``, read the same way, in the cell of the published
64,000-atom float64 run (the float64 route at the headline size)."""

from gmg_bench.cells import metric_reader

read = metric_reader("stage.assemble_mg_s")
