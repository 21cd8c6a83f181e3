"""Named-scope walltime accounting.

Analogue of deal.II ``TimerOutput`` with wall_times summary
(src/step-50.cc:118-119, 1563-1564): every pipeline stage opens a named
scope; `summary()` prints a table with the reference's section names so the
shipped log parsers (out_parse_*_walltime.py) keep working.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.calls = defaultdict(int)
        self._t0 = time.time()

    @contextmanager
    def scope(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - start
            self.calls[name] += 1

    def reset(self):
        self.totals.clear()
        self.calls.clear()
        self._t0 = time.time()

    def total_wall(self) -> float:
        return time.time() - self._t0

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
