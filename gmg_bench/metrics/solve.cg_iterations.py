"""CG iterations of a solve: every refinement pass of every cycle, as the
program counts them (`results[i]["cg_iterations"]`), averaged over the
window's solves."""

def read(ctx):
    solves = ctx.get("solves") or []
    if not solves:
        return None
    return sum(sum(s["cg"]) for s in solves) / len(solves)
