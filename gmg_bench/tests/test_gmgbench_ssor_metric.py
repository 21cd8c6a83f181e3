"""The metric ``smoother.ssor_card_calls`` of the 1,000-atom cell loads by
name and reads the program's counter ``ssor_card_calls`` averaged over the
window's solves, or None where no solve counted it (the host smoother, or
a program without the card sweep)."""

import collections

import pytest

from gmg_bench import cells

CELL = "nacl1k_f64.production"
NAME = "smoother.ssor_card_calls"


def test_the_metric_loads_by_name_for_the_cell():
    cell = cells.find_cell(CELL)
    m = next(m for m in cell.per_layer if m["name"] == NAME)
    assert m["workloads"] == [CELL] and m["moves"] == "time_to_solution_s"
    assert m["source"] == "program_counter" and m["layer"] == "solve"
    assert callable(cells.metric_reader(NAME))


def _ctx(monkeypatch, counters):
    from coulomb_gmg_tpu_torch.utils import timer
    runs = collections.deque(
        [{"cells": [8], "spans": {"run": {"total_s": 1.0}},
          "counters": c} for c in counters], maxlen=64)
    monkeypatch.setattr(timer, "RUNS", runs)
    return {"solves": [{"cells": [8]}] * (len(counters) - 1)}


@pytest.mark.parametrize("counters, want", [
    ([{"Solve": {"ssor_card_calls": 170}},
      {"Solve": {"ssor_card_calls": 190}, "run": {"ssor_card_calls": 2}},
      {"Solve": {"ssor_card_calls": 1}}], 181.0),
    ([{"Solve": {"host_reads": 9}}, {}, {"Solve": {"ssor_card_calls": 5}}],
     None),
])
def test_the_metric_reads_the_counter(monkeypatch, counters, want):
    """The window's solves are the runs before the last (the traced one);
    a solve's count sums its stages."""
    assert cells.metric_reader(NAME)(_ctx(monkeypatch, counters)) == want
