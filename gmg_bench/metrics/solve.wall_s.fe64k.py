"""``solve.wall_s``, read the same way, in the default-run cell (FE error,
volume-term Kelly, all-atom density at 64,000 atoms)."""

from gmg_bench.cells import metric_reader

read = metric_reader("solve.wall_s")
