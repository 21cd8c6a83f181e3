"""``ell_spmv_roofline``, read the same way, in the cell of the published
64,000-atom float64 run: the float64 sliced ELL of the system, levels,
interfaces and prolongations at the headline size."""

from gmg_bench.cells import metric_reader

read = metric_reader("ell_spmv_roofline")
