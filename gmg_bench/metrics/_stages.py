"""Stage seconds of the program's driver (``Simulation._stage``: host
seconds around each stage, the card synchronized at its end), summed over
a solve's cycles and averaged over the window's solves."""

from __future__ import annotations


def mean_stage(ctx: dict, *names: str):
    """Seconds a solve spent in the stages ``names``; None where no solve
    of the window ran any of them."""
    solves = ctx.get("solves") or []
    per = [sum(v for k, v in s["stages"].items() if k in names)
           for s in solves]
    if not any(any(k in names for k in s["stages"]) for s in solves):
        return None
    return sum(per) / len(per)
