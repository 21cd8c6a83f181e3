"""What a ``--trace 1`` run reads beside the stage seconds: one more whole
solve under ``torch.profiler``, with every hand-kernel launch of it
recorded by the benchmark's own wrappers.

* :class:`LaunchLog` wraps the program's CUDA launcher of every kernel
  of ``gmg_bench/kernels/`` (``MODULE``, ``LAUNCHER``: each wrapper of the
  program looks its launcher up in its module at every call) and
  ``torch.cuda.CUDAGraph``.  A launch made while a graph is captured counts
  once for every replay of that graph, any other once.  The arguments are
  kept; the work is counted after the window (each kernel's ``bound_s``,
  gmg_bench/metrics/_roofline.py:share), so no stage pays for it.
* :class:`Spans` wraps the ``Simulation``'s stage methods of the traced
  solve in ``record_function`` spans named after them, which name the idle
  gaps of the device.
* :func:`reduce` turns the profiler's events into the device's busy
  seconds (the union of kernel, copy and set intervals), the window,
  the device time of each kernel of the log (by the names of its device
  functions, ``DEVICE``), and the breakdown: the device operations that
  took most time and the longest idle gaps, each named by the spans and
  the host operation running at its middle.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict

import numpy as np
import torch

from gmg_bench import cells

STAGE_METHODS = ("setup", "assemble_system", "assemble_multigrid", "solve",
                 "estimate_and_mark", "refine")
SPAN = "gmg_bench."


class LaunchLog(contextlib.AbstractContextManager):
    """Every launch of the kernels of ``gmg_bench/kernels/`` of the
    benchmark at ``root`` made inside the ``with`` block: ``calls[kernel]``
    lists ``(args, kwargs, graph)``, ``graph`` the record ``{"replays": n}``
    of the graph it was captured into, or None; ``kernels[kernel]`` is the
    kernel's file."""

    def __init__(self, root: str = cells.ROOT):
        self.kernels = cells.kernels(root)
        self.calls = defaultdict(list)
        self._saved = []
        self._capturing = None

    def weight(self, graph) -> int:
        return 1 if graph is None else graph["replays"]

    def __enter__(self):
        for kernel, spec in self.kernels.items():
            mod = importlib.import_module(spec.MODULE)
            orig = getattr(mod, spec.LAUNCHER)
            self._saved.append((mod, spec.LAUNCHER, orig))
            setattr(mod, spec.LAUNCHER, self._recorder(kernel, orig))
        G = torch.cuda.CUDAGraph
        for attr, make in (("capture_begin", self._begin),
                           ("capture_end", self._end),
                           ("replay", self._replay)):
            orig = G.__dict__.get(attr, getattr(G, attr))
            self._saved.append((G, attr, orig))
            setattr(G, attr, make(orig))
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in reversed(self._saved):
            setattr(obj, attr, orig)
        self._saved = []
        return False

    def _recorder(self, kernel, orig):
        def launch(*args, **kw):
            self.calls[kernel].append((args, kw, self._capturing))
            return orig(*args, **kw)
        return launch

    def _begin(self, orig):
        log = self

        def capture_begin(graph, *a, **k):
            log._capturing = {"replays": 0}
            return orig(graph, *a, **k)
        return capture_begin

    def _end(self, orig):
        log = self

        def capture_end(graph, *a, **k):
            out = orig(graph, *a, **k)
            graph._gmg_bench_launches = log._capturing
            log._capturing = None
            return out
        return capture_end

    def _replay(self, orig):
        def replay(graph, *a, **k):
            rec = getattr(graph, "_gmg_bench_launches", None)
            if rec is not None:
                rec["replays"] += 1
            return orig(graph, *a, **k)
        return replay


class Spans:
    """``record_function`` spans around the stage methods of one
    ``Simulation`` (an instance's own attributes; the class is untouched)."""

    def __init__(self, sim):
        for name in STAGE_METHODS:
            fn = getattr(sim, name, None)
            if fn is not None:
                setattr(sim, name, self._span(name, fn))

    @staticmethod
    def _span(name, fn):
        def run(*a, **k):
            with torch.profiler.record_function(SPAN + name):
                return fn(*a, **k)
        return run


def _events(prof):
    """(name, start ns, end ns, on the device) of every event; the
    device's copies of the host's annotations are left out, since they
    span whole stages and are no work of the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and (e.is_user_annotation() or e.name().startswith(SPAN)):
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns(), dev))
    return out


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of (start, end) intervals, sorted, as disjoint intervals."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], 1)


def reduce(prof, window_span: str, kernels: dict, top: int = 10) -> dict:
    """busy_s, window_s, the device seconds of each of ``kernels`` (the
    files of gmg_bench/kernels/ by name) and the breakdown of one profiled
    window, the span ``window_span`` around it."""
    ev = _events(prof)
    win = [(s, e) for n, s, e, dev in ev if not dev and n == window_span]
    if not win:
        raise RuntimeError(f"no span {window_span!r} in the trace")
    w0, w1 = win[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e, d in ev
           if d and e > w0 and s < w1]
    busy = _merge(np.array([(s, e) for _, s, e in dev], np.int64))
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    by_name = defaultdict(int)
    for n, s, e in dev:
        by_name[n] += e - s
    kernel_s = {k: sum(t for n, t in by_name.items()
                       if any(f in n for f in spec.DEVICE)) / 1e9
                for k, spec in kernels.items()}
    launches = {k: sum(1 for n, _, _ in dev
                       if any(f in n for f in spec.DEVICE))
                for k, spec in kernels.items()}
    edges = np.r_[w0, busy.reshape(-1), w1].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:top]
    host = [(n, s, e) for n, s, e, d in ev if not d and n != window_span]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    idle = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        on = np.nonzero((hs <= mid) & (he >= mid))[0]
        spans = [host[i] for i in on if host[i][0].startswith(SPAN)]
        ops = [host[i] for i in on if not host[i][0].startswith(SPAN)]
        name = " / ".join(
            [min(spans, key=lambda h: h[2] - h[1])[0][len(SPAN):]
             if spans else "outside the stages"]
            + ([min(ops, key=lambda h: h[2] - h[1])[0]] if ops else []))
        idle.append([name[:120], (g1 - g0) / 1e9])
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernel_s": kernel_s, "kernel_events": launches,
            "breakdown": {"device_ops": [[n[:120], t / 1e9]
                                         for n, t in device_ops],
                          "idle_gaps": idle}}
