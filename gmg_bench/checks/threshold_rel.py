"""The largest ``|theta_program - theta_ref| / theta_ref`` over the sampled
solve's cycles: the program's refinement threshold (``run()``'s
``threshold``) against the reference's, ``refine_fraction_of_max`` times
the largest indicator of gmg_bench/reference/kelly.py on the same mesh and
solution (gmg_bench/checks/_marking.py).  None where the program reports
no threshold."""

from gmg_bench.checks._marking import marking


def read(ctx):
    m = marking(ctx)
    if any(t is None for t in m["theta"]):
        return None
    return max(abs(t - r) / r for t, r in zip(m["theta"], m["theta_ref"]))
