"""The program's record of its finished runs
(``coulomb_gmg_tpu_torch/utils/timer.py:RUNS``: each run's seconds by span
name, total and self, its counters by enclosing stage, its cells per
cycle), averaged over the window's solves: the ``len(ctx["solves"])``
runs just before the last one, the last being the traced solve that
``run_cell`` runs before it reads the metrics.  None where the program
keeps no such record, or where the record's cells per cycle are not the
window's."""

from __future__ import annotations


def window_runs(ctx: dict):
    """The window's runs in the program's record, or None."""
    solves = ctx.get("solves") or []
    if not solves:
        return None
    try:
        from coulomb_gmg_tpu_torch.utils.timer import RUNS
    except ImportError:
        return None
    runs = list(RUNS)[-len(solves) - 1:-1]
    if len(runs) != len(solves) or any(
            r.get("cells") != s["cells"] for r, s in zip(runs, solves)):
        return None
    return runs


def _mean(runs, values):
    if runs is None or not any(v is not None for v in values):
        return None
    return sum(v or 0 for v in values) / len(runs)


def mean_span(ctx: dict, name: str, key: str = "total_s"):
    """Seconds a solve spent in the spans ``name`` (``key``: ``total_s``
    or ``self_s``, the time in no child span); None where no run of the
    window opened one."""
    runs = window_runs(ctx)
    return _mean(runs, [r["spans"].get(name, {}).get(key)
                        for r in runs or ()])


def mean_counter(ctx: dict, name: str, stage: str = None):
    """A solve's counter ``name``, inside the stage ``stage`` or over the
    whole run; None where no run of the window counted it."""
    runs = window_runs(ctx)
    vals = []
    for r in runs or ():
        got = [c[name] for s, c in r["counters"].items()
               if name in c and (stage is None or s == stage)]
        vals.append(sum(got) if got else None)
    return _mean(runs, vals)
