"""``host.refine_forest_s``, read the same way, in cells that report no
``time_to_solution_s`` end to end (BENCHMARK.json names them)."""

from gmg_bench.cells import metric_reader

read = metric_reader("host.refine_forest_s")
