"""One file per check of the comparison that is not built into
gmg_bench/check.py, ``<key>.py``, found by the key of a cell's limits
(gmg_bench/cells.py:check_readers): a ``read(ctx)`` that returns the
number held to ``<= limit``.  ``ctx`` holds ``snapshots`` (the sampled
solve's cycles: ``level``, ``ijk``, ``positions``, ``solution`` and the
scalar outputs of gmg_bench/run.py:SCALARS), ``positions`` and
``charges`` (the atoms as that solve listed them), ``settings`` (the
configuration's, then the traffic's), ``seed`` and ``device``.  It runs
after the window, with the program's state freed.  Files whose names
start with ``_`` hold shared arithmetic."""
