"""One file per hand kernel of the program, ``<kernel>.py``, found by name
(gmg_bench/cells.py:kernels): ``MODULE`` and ``LAUNCHER``, the program's
module and the function in it that launches the kernel, which
gmg_bench/trace.py:LaunchLog wraps to record each launch; ``DEVICE``, the
names of the device functions that the launcher runs, by which
gmg_bench/trace.py:reduce finds its device time in the trace; and
``bound_s(args, kw)``, the least time one H100 takes for the work of one
launch with those arguments, counted from the problem
(gmg_bench/metrics/_roofline.py).  Files whose names start with ``_``
hold shared arithmetic."""
