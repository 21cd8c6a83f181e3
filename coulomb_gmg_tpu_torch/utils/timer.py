"""Named-scope walltime accounting, and the tracer of one run.

Analogue of deal.II ``TimerOutput`` with wall_times summary
(src/step-50.cc:118-119, 1563-1564): every pipeline stage opens a named
scope; `summary()` prints a table with the reference's section names so the
shipped log parsers (out_parse_*_walltime.py) keep working.

A :class:`TimerOutput` is also the tracer of the ``Simulation.run`` that
owns it, one run being the system's unit of request:

* **spans**: every stage scope, and every span that a module below the
  driver opens with :func:`span`, records its name, start and end on one
  monotonic clock (``time.perf_counter_ns``), its parent span and its run
  (``TimerOutput.spans``).  A span is a context manager that closes on
  exceptions too.  While ``torch.profiler`` records, each span is also a
  ``record_function`` range of the same name, so the program's spans lie on
  the profiler's clock over the device's work; without a profiler no range
  is made;
* **counters** (:func:`count`): ``uploads`` / ``upload_bytes`` (device.py:
  upload), ``readbacks`` / ``readback_bytes`` (device.py: read_back),
  ``host_reads`` / ``host_read_ns`` (solver/cg.py), each added to the
  innermost open span and to its enclosing stage (``"run"`` outside every
  stage);
* **the finished-run record** :data:`RUNS`: when a run ends its summary
  (seconds by span name, total and self; counters by stage and by span;
  the cycles' cell counts) is appended there, the last 64 runs kept, so
  that a caller embedding the program reads a run after its
  ``Simulation`` is gone.  Spans live in memory only.

:func:`span`, :func:`spanned` and :func:`count` act through the tracer of the run that is
open (:meth:`TimerOutput.run`); outside a run they do nothing, so the
modules below the driver take no tracer argument.
"""

from __future__ import annotations

import functools
import itertools
from collections import defaultdict, deque
from contextlib import nullcontext
from time import perf_counter_ns

import torch

RUNS: deque = deque(maxlen=64)     # summaries of finished runs, oldest first
_run_ids = itertools.count()
_active = None                     # the TimerOutput of the open run
_NULL = nullcontext()


def _recording() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    """One span of ``tracer``: a stage (``stage``: feeds ``totals`` and
    ``calls``; ``sync`` is called at its end, before the clock is read,
    unless it raised) or a span below the stages."""

    __slots__ = ("tr", "name", "stage", "sync", "rec", "rf", "seconds")

    def __init__(self, tr, name, stage=False, sync=None):
        self.tr, self.name, self.stage, self.sync = tr, name, stage, sync
        self.rec = self.rf = None
        self.seconds = 0.0

    def __enter__(self):
        tr = self.tr
        if _recording():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        t0 = perf_counter_ns()
        if tr._run is not None:
            top = tr._open[-1]
            stage = self.name if self.stage else top[2]
            self.rec = [self.name, t0, t0, top[0], tr._run]
            tr._open.append((len(tr.spans), self.name, stage))
            tr.spans.append(self.rec)
        else:
            self.rec = [self.name, t0, t0, -1, None]
        return self

    def __exit__(self, typ, exc, tb):
        if typ is None and self.sync is not None:
            self.sync()
        t1 = perf_counter_ns()
        rec, tr = self.rec, self.tr
        rec[2] = t1
        if rec[4] is not None:
            tr._open.pop()
        self.seconds = (t1 - rec[1]) * 1e-9
        if self.stage:
            tr.totals[self.name] += self.seconds
            tr.calls[self.name] += 1
        if self.rf is not None:
            self.rf.__exit__(typ, exc, tb)
        return False


class _Run:
    """The root span ``run`` of ``tracer``, its tracer the active one."""

    def __init__(self, tr):
        self.tr = tr
        self.root = None
        self.prev = None

    def __enter__(self):
        global _active
        tr = self.tr
        tr.spans, tr.counters, tr.cells = [], {}, []
        tr._run = next(_run_ids)
        tr._open = [(-1, "run", "run")]
        self.prev, _active = _active, tr
        self.root = _Span(tr, "run").__enter__()
        return tr

    def __exit__(self, typ, exc, tb):
        global _active
        try:
            self.root.__exit__(typ, exc, tb)
        finally:
            _active = self.prev
            RUNS.append(self.tr.summarize())
            self.tr._run = None
        return False


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.calls = defaultdict(int)
        self._t0 = perf_counter_ns()
        self.spans = []       # [name, start ns, end ns, parent index, run]
        self.counters = {}    # (innermost span, stage, counter) -> total
        self.cells = []       # the run's cells per cycle (Simulation.run)
        self._run = None      # the open run's id
        self._open = []       # open spans: (index, name, enclosing stage)

    def scope(self, name: str, sync=None) -> _Span:
        """A stage: its seconds go to ``totals[name]`` and ``calls[name]``
        (and ``.seconds`` of the returned span); ``sync`` is called at its
        end, inside the span, unless the stage raised."""
        return _Span(self, name, stage=True, sync=sync)

    def run(self) -> _Run:
        """The context of one run: its root span ``run``, this tracer the
        one that :func:`span` and :func:`count` act through, and the
        run's summary appended to :data:`RUNS` at its end."""
        return _Run(self)

    def summarize(self) -> dict:
        """The run's seconds by span name (``calls``, ``total_s``,
        ``self_s``: the span's time in no child span), its counters by
        enclosing stage and by innermost span, and its cells per cycle."""
        child = [0] * len(self.spans)
        for name, t0, t1, parent, _ in self.spans:
            if parent >= 0:
                child[parent] += t1 - t0
        spans = {}
        for (name, t0, t1, _, _), c in zip(self.spans, child):
            s = spans.setdefault(name, {"calls": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["calls"] += 1
            s["total_s"] += (t1 - t0) * 1e-9
            s["self_s"] += (t1 - t0 - c) * 1e-9
        by_stage, by_span = {}, {}
        for (where, stage, key), v in self.counters.items():
            d = by_stage.setdefault(stage, {})
            d[key] = d.get(key, 0) + v
            d = by_span.setdefault(where, {})
            d[key] = d.get(key, 0) + v
        return {"run": self._run, "cells": list(self.cells),
                "wall_s": spans.get("run", {}).get("total_s", 0.0),
                "spans": spans, "counters": by_stage,
                "counters_by_span": by_span}

    def reset(self):
        self.totals.clear()
        self.calls.clear()
        self._t0 = perf_counter_ns()

    def total_wall(self) -> float:
        return (perf_counter_ns() - self._t0) * 1e-9

    def summary(self, pcout) -> None:
        total = self.total_wall()
        pcout("")
        pcout("+---------------------------------------------+------------"
              "+------------+")
        pcout("| Total wallclock time elapsed since start    |"
              f" {total:9.3g}s |            |")
        pcout("|                                             |            "
              "|            |")
        pcout("| Section                         | no. calls |  wall time "
              "| % of total |")
        pcout("+---------------------------------+-----------+------------"
              "+------------+")
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            pct = 100.0 * t / total if total > 0 else 0.0
            pcout(f"| {name:<31s} | {self.calls[name]:9d} | {t:9.3g}s "
                  f"| {pct:9.3g}% |")
        pcout("+---------------------------------+-----------+------------"
              "+------------+")


def span(name: str):
    """A span ``name`` of the open run (a context manager); a no-op outside
    a run."""
    tr = _active
    return _NULL if tr is None else _Span(tr, name)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span and of
    its enclosing stage; nothing outside a run."""
    tr = _active
    if tr is None:
        return
    _, where, stage = tr._open[-1]
    key = (where, stage, name)
    tr.counters[key] = tr.counters.get(key, 0) + n


def tracing() -> bool:
    """Whether a run is open, so that spans and counters record."""
    return _active is not None
