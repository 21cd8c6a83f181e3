"""The run's tracer (coulomb_gmg_tpu_torch/utils/timer.py): spans with
parents and self time on one monotonic clock, counters attributed to the
innermost span and its stage, ``record_function`` ranges only while a
profiler records, the counted uploads and host reads, the bounded record
of finished runs, and an 8-atom run of the driver traced end to end (its
stage keys and summary sections as before).  Imports no JAX: the card
test runs with ``--noconftest``."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.solver.cg import host_array, host_float, to_host
from coulomb_gmg_tpu_torch.utils import timer as T
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from coulomb_gmg_tpu_torch.utils.timer import RUNS, TimerOutput, count, span

# the driver's stages of the 8-atom production run, cycle 0 and later
STAGES_0 = ["Setup system", "Compute charge densities",
            "Compute dipole moments", "Assemble Multigrid",
            "Assemble system", "Solve", "Estimate error and mark cells",
            "Postprocess electrostatic energy"]
REFINE = "Refine, solution transfer and sending atoms list to child cells"


def _by_name(tr):
    return {rec[0]: rec for rec in tr.spans}


def test_spans_nest_with_parents_and_self_time():
    tr = TimerOutput()
    with tr.run():
        with tr.scope("Solve"):
            with span("solve.cg"):
                with span("solve.coarse"):
                    pass
            with span("solve.check"):
                pass
    recs = _by_name(tr)
    names = [r[0] for r in tr.spans]
    assert names == ["run", "Solve", "solve.cg", "solve.coarse",
                     "solve.check"]
    parent = {r[0]: (tr.spans[r[3]][0] if r[3] >= 0 else None)
              for r in tr.spans}
    assert parent == {"run": None, "Solve": "run", "solve.cg": "Solve",
                      "solve.coarse": "solve.cg", "solve.check": "Solve"}
    assert len({r[4] for r in tr.spans}) == 1
    for r in tr.spans:
        assert r[1] <= r[2]
        if r[3] >= 0:
            p = tr.spans[r[3]]
            assert p[1] <= r[1] and r[2] <= p[2]
    s = tr.summarize()["spans"]
    cg = recs["solve.cg"]
    assert s["solve.cg"]["self_s"] == pytest.approx(
        (cg[2] - cg[1] - (recs["solve.coarse"][2] - recs["solve.coarse"][1]))
        * 1e-9, abs=1e-12)
    assert s["solve.coarse"]["self_s"] == s["solve.coarse"]["total_s"]
    assert s["run"]["calls"] == 1 and tr.calls["Solve"] == 1
    assert tr.totals["Solve"] == pytest.approx(s["Solve"]["total_s"])


def test_a_span_unwinds_on_an_exception():
    tr = TimerOutput()
    synced = []
    with pytest.raises(ValueError):
        with tr.run():
            with tr.scope("Solve", sync=lambda: synced.append(1)):
                with span("solve.cg"):
                    raise ValueError("no convergence")
    assert T._active is None and tr._run is None
    assert [r[0] for r in tr.spans] == ["run", "Solve", "solve.cg"]
    assert all(r[2] >= r[1] for r in tr.spans)
    assert tr.calls["Solve"] == 1 and synced == []
    assert RUNS[-1]["spans"]["solve.cg"]["calls"] == 1
    with tr.run():                    # the next run starts clean
        with span("solve.cg"):
            pass
    assert [r[0] for r in tr.spans] == ["run", "solve.cg"]


def test_a_counter_goes_to_the_innermost_span_and_its_stage():
    tr = TimerOutput()
    with tr.run():
        count("uploads")
        with tr.scope("Solve"):
            count("host_reads", 2)
            with span("solve.cg"):
                with span("solve.coarse"):
                    count("host_reads")
                    count("host_read_ns", 500)
    run = tr.summarize()
    assert run["counters"] == {"run": {"uploads": 1},
                               "Solve": {"host_reads": 3,
                                         "host_read_ns": 500}}
    assert run["counters_by_span"] == {
        "run": {"uploads": 1}, "Solve": {"host_reads": 2},
        "solve.coarse": {"host_reads": 1, "host_read_ns": 500}}


def test_a_span_outside_a_run_does_nothing():
    assert not T.tracing()
    n = len(RUNS)
    with span("solve.cg") as s:
        count("uploads")
    assert s is None and len(RUNS) == n
    tr = TimerOutput()
    with tr.scope("Solve") as st:     # a stage outside a run: seconds only
        pass
    assert tr.spans == [] and tr.counters == {}
    assert tr.calls["Solve"] == 1 and st.seconds >= 0.0


def test_program_spans_reach_the_profiler_and_only_it(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    tr = TimerOutput()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.run(), tr.scope("Solve"), span("solve.cg"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"run", "Solve", "solve.cg"} <= names
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    with tr.run(), tr.scope("Solve"), span("solve.cg"):
        pass
    assert made == [] and [r[0] for r in tr.spans] == ["run", "Solve",
                                                       "solve.cg"]


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.float64,
                                   torch.int64])
def test_upload_is_from_numpy_to(dtype):
    a = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
    want = (torch.from_numpy(a).to("cpu") if dtype is None
            else torch.from_numpy(a).to("cpu", dtype))
    tr = TimerOutput()
    with tr.run():
        got = upload(a, "cpu", dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert tr.summarize()["counters"]["run"] == {"uploads": 1,
                                                 "upload_bytes": a.nbytes}
    assert torch.equal(upload(a, "cpu", dtype), want)   # outside a run


def test_host_reads_are_counted_and_to_host_keeps_its_count():
    t = torch.tensor([1.5, 2.5], dtype=torch.float64)
    reads = to_host.reads
    tr = TimerOutput()
    with tr.run(), tr.scope("Solve"):
        assert host_float(t.sum()) == 4.0
        assert np.array_equal(host_array(t), [1.5, 2.5])
        assert to_host(t) == [1.5, 2.5]
    assert to_host.reads == reads + 1
    solve = tr.summarize()["counters"]["Solve"]
    assert solve["host_reads"] == 3 and solve["host_read_ns"] > 0


def test_the_finished_run_record_is_bounded():
    tr = TimerOutput()
    for i in range(RUNS.maxlen + 6):
        with tr.run():
            tr.cells.append(i)
    assert len(RUNS) == RUNS.maxlen == 64
    assert [r["cells"] for r in list(RUNS)[-2:]] == [[RUNS.maxlen + 4],
                                                    [RUNS.maxlen + 5]]
    assert RUNS[-1]["run"] > RUNS[0]["run"]


def _run8(device, cycles=2):
    cfg = production_scaling_config(1, dtype="float32",
                                    n_adaptive_cycles=cycles)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device=device,
                     pcout=Pcout(enabled=False))
    return sim, sim.run(), RUNS[-1]


def test_the_8_atom_run_is_traced_end_to_end():
    from gmg_bench.metrics import _spans
    sim, res, run = _run8("cpu")
    tr = sim.timer
    assert list(res[0]["stages"]) == STAGES_0
    assert list(res[1]["stages"]) == [REFINE] + STAGES_0
    assert run["cells"] == [r["n_cells"] for r in res]
    # every stage is a span, fed from the same clock readings
    for name in tr.totals:
        assert run["spans"][name]["calls"] == tr.calls[name]
        assert run["spans"][name]["total_s"] == pytest.approx(
            tr.totals[name], rel=1e-9)
    assert sum(r["stages"]["Solve"] for r in res) == pytest.approx(
        tr.totals["Solve"], rel=1e-9)
    for name in ("topology.mesh", "topology.dofs", "topology.constraints",
                 "topology.refine", "topology.transfer", "density.plan",
                 "density.upload", "density.kernel", "mg.levels",
                 "solve.cg", "solve.check", "estimate.face_plan"):
        assert run["spans"][name]["calls"] >= 1, name
    for r in tr.spans:
        if r[3] >= 0:
            p = tr.spans[r[3]]
            assert p[1] <= r[1] <= r[2] <= p[2] and p[4] == r[4]
    assert run["counters"]["Solve"]["host_reads"] > 0
    lines = []
    tr.summary(lines.append)
    sections = {ln.split("|")[1].strip() for ln in lines[6:-1]}
    assert sections == set(STAGES_0) | {REFINE}
    # the benchmark's readers, with this run as the window and an empty
    # run in place of the traced solve
    ctx = {"solves": [{"cells": run["cells"]}]}
    with TimerOutput().run():
        pass
    for name in ("density.plan", "topology.constraints", "topology.refine"):
        assert _spans.mean_span(ctx, name) == pytest.approx(
            run["spans"][name]["total_s"])
    assert _spans.mean_counter(ctx, "host_reads", stage="Solve") > 0
    assert _spans.mean_span({"solves": [{"cells": [1]}]}, "run") is None


def test_the_host_assembled_route_has_its_spans():
    """The float64 route of the 1k cell: host CSR assembly, the host SSOR
    smoother and the coarse CG each in their spans, the Solve's reads and
    the SSOR's copies back counted in it."""
    cfg = production_scaling_config(1, dtype="float64", n_adaptive_cycles=2)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     pcout=Pcout(enabled=False))
    res = sim.run()
    run = RUNS[-1]
    assert list(res[0]["stages"]) == [
        "Setup system", "RHS assembly optimization",
        "Compute charge densities", "Compute dipole moments",
        "Assemble system", "Assemble Multigrid", "Solve",
        "Estimate error and mark cells", "Postprocess electrostatic energy"]
    for name in ("assembly.csr", "smoother.ssor_host", "solve.coarse",
                 "solve.cg", "solve.check", "density.plan"):
        assert run["spans"][name]["calls"] >= 1, name
    assert run["spans"]["Solve"]["self_s"] < run["spans"]["Solve"]["total_s"]
    solve = run["counters"]["Solve"]
    assert solve["host_reads"] > sum(r["cg_iterations"] for r in res)
    assert solve["uploads"] >= run["spans"]["smoother.ssor_host"]["calls"]


@pytest.mark.cuda
def test_the_8_atom_run_counts_uploads_and_reads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sim, res, run = _run8("cuda")
    assert run["counters"]["Solve"]["host_reads"] > 0
    assert sum(c.get("upload_bytes", 0)
               for c in run["counters"].values()) > 0
    assert run["spans"]["graphs.capture"]["calls"] == len(res)
