"""One reader per per-layer metric, ``<metric name>.py`` with a
``read(ctx)`` that returns the value, or None where the run gave it
nothing to read.  Files whose names start with ``_`` hold the shared
arithmetic."""
