"""Seconds a solve takes, wall to wall: the measured window's wall time
over the solves it completed, as ``time_to_solution_s`` is taken, in cells
whose host spreads too widely for that metric's bound."""


def read(ctx):
    solves = ctx.get("solves") or []
    if not solves or not ctx.get("window_s"):
        return None
    return ctx["window_s"] / len(solves)
