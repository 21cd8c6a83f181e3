"""Benchmark of ``coulomb_gmg_tpu_torch`` on NVIDIA cards.

``python -m gmg_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json``: whole adaptive solves of a seeded NaCl lattice back to
back for ``--seconds``, then the comparison of a sampled solve with the
plain float64 reference in ``gmg_bench/reference/``.  Everything that
belongs to one configuration, traffic mix, per-layer metric, cell limit,
check or kernel is a file of its own, found by its name
(gmg_bench/cells.py).
"""
