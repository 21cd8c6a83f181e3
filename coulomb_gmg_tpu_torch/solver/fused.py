"""The one-dispatch GMG-CG: a solve as device state, a start and a step.

Counterpart of coulomb_gmg_tpu/solver/tpu_gmg.py:_fused_gmg_cg, which runs
the whole GMG-preconditioned CG (V-cycles, the DST or Chebyshev-CG coarse
solve, the outer CG) as one jitted executable with a ``lax.while_loop``:
one dispatch and one small read per solve.  Here the state of the solve
lives in static device tensors (``x``, ``r``, ``p``, ``rho``, ``res2``,
``res0_2``, ``k``, ``active`` and the inputs ``rhs``, ``tol2``,
``maxiter``); ``start`` and ``step`` compute what the eager loop
solver/gmg.py:gmg_cg computes, op for op, and write it into that state,
stopping test included, so the two give the same bits and the same counts.

On the card each segment is a CUDA graph (:class:`Segments`), captured once
per operator set and replayed for every solve on it (every refinement pass
of a cycle).  PyTorch on the card (2.11) has no conditional graph nodes
(``CUDAGraph.begin_capture_to_if_node``), so a replay always runs its whole
body: the host reads one small tensor (``info``: active, k, |r0|^2, |r|^2)
before every replay of the step, and no replay runs past the stop.  One
replay a read, because on the H100 an 8,000-atom step replays in
0.83-0.84 ms against a 0.015-0.020 ms read (chip_smoke.py phase 12, last
cycle of the float32 production run): a replay past the stop would cost
some forty reads, and it would change the state.

Operators without the DST (level 0 not a full box of >= 3 cells per axis)
need the coarse CG inside every V-cycle, a nested data-dependent loop.  The
step is then three graphs: up to the level-0 defect and the coarse CG's
start, one coarse iteration (replayed after each read of its own flag), the
prolongation and post-smoothing to the end of
the step; ``start`` is split the same way.

On the CPU the same functions run eagerly, one call standing for each
replay, so the CPU tests run the code that the card captures.  So do the
stepped solves of parallel/ whose topology cannot be captured
(``capture=False``: shards on the CPU, process groups under gloo, cards
without peer access; parallel/spmd.py:SpmdContext.graph_mode).

A stepped sharded solve whose shards lie on several cards of one process
captures each segment as ONE graph over all of them: the capture begins
on the first card's side stream, every other card's side stream joins it
by an event wait, and each card's work is captured on its own side
stream.  A copy from one card to another (``Tensor.to``) is then a peer
copy between two captured events, as PyTorch orders a copy across cards
(the receiver's stream ready, the copy on the sender's stream, the
receiver waiting for it), and the graph's nodes on every card replay in
that order.  One graph a card was the other form: a graph's event wait
resolves when it is launched, so a card whose graph waits for a later
card's record (every ``psum`` does, and every halo import back) would
read the previous replay's data, unless each segment were cut into a
graph per exchange.  Across processes under NCCL, the collectives are
captured on the rank's stream like any other work.

:class:`SteppedCG` is solver/cg.py's CG in the same form, over per-shard
lists: the one-device Jacobi route of the driver (one shard) and the
sharded Jacobi-CG (parallel/sharded.py).
"""

from __future__ import annotations

import gc
import time
from time import perf_counter_ns
from contextlib import ExitStack, contextmanager
from typing import Callable, Optional

import torch

from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.solver.cg import CGResult, to_host
from coulomb_gmg_tpu_torch.utils.timer import span
from coulomb_gmg_tpu_torch.solver.gmg import (_safe_div, _smooth, sys_mv,
                                              tol_squared, vcycle,
                                              vcycle_down, vcycle_up)

# The launch counters of the kernels a solve reaches (ops/ell.py).
COUNTERS = ((ell_mv, "launches"), (ell_mv, "launches_f64"))


class Segments:
    """Named segments of a stepped solve.  On the card each is a CUDA graph,
    captured by :meth:`prepare` after a warm-up of every segment on side
    streams (which also loads every kernel library); a capture or replay
    that fails raises, and nothing runs the segments uncaptured instead.
    For CPU tensors, and with ``capture=False``, :meth:`run` calls the
    function.

    ``device`` is the card that replays the graphs; ``devices`` lists
    every card the segments' work runs on (the shards' cards, module
    docstring).  Each card has its side stream; the graphs' memory is one
    pool on ``device`` (the graphs' own) and a ``torch.cuda.MemPool`` on
    each other card, into which that card's allocations go while a graph
    is captured, so no later allocation takes memory that a replay
    writes.  ``comm``: a ``SpmdContext`` whose collectives the segments
    call; its ``stats`` count what each replay moves.

    The kernel launch counters (``COUNTERS`` and kernels.LAUNCHES, by
    card) count what the cards run.  The warm-up launches kernels, and the
    wrappers count them as they come (``warmup`` keeps their number).  A
    capture records kernels and runs none: the counts that the wrappers
    make during a capture are taken back and kept as the segment's
    launches, which every replay runs and adds; the collectives' calls
    and bytes likewise.  A graph solve thus counts the eager loop's
    launches plus its warm-up's.  The capture skips
    ``torch.cuda.graph``'s ``empty_cache``, which would drop the
    allocator's cache once per cycle."""

    # device -> the side stream of every warm-up and capture on it: each new
    # stream would get its own cuBLAS workspace, kept for the process's life
    _side_streams: dict = {}

    def __init__(self, fns: dict, device: torch.device,
                 capture: Optional[bool] = None, devices=(), comm=None):
        self.fns = fns
        self.device = torch.device(device)
        self.capture = (self.device.type != "cpu" if capture is None
                        else capture)
        self.others = [torch.device(d) for d in dict.fromkeys(devices)
                       if torch.device(d) != self.device]
        self.comm = comm
        self.graphs = None
        self.pools = {}           # other card -> its MemPool
        self.launches = {}        # segment -> [(counter, launches a replay)]
        self.cards = {}           # segment -> {(kernel, card): a replay's}
        self.moved = {}           # segment -> (calls, bytes) a replay's
        self.warmup = {}          # counter attribute -> warm-up launches
        # the warm-up, captures and instantiations are one span
        # ``graphs.capture`` of the run; these two read the same clock
        self.capture_s = 0.0      # capture of every segment
        self.instantiate_s = 0.0  # capture_end: instantiation of the graphs
        self._fence = False

    def prepare(self) -> None:
        """Capture the graphs if there are none yet (on the card); the
        warm-up writes the state, so call this before loading inputs."""
        if self.capture and self.graphs is None:
            with span("graphs.capture"):
                self._capture()
        self._fence = bool(self.others)

    def run(self, name: str) -> None:
        if not self.capture:
            self.fns[name]()
            return
        if self._fence:
            # the inputs were loaded on the other cards' current streams
            here = torch.cuda.current_stream(self.device)
            for d in self.others:
                here.wait_stream(torch.cuda.current_stream(d))
            self._fence = False
        self.graphs[name].replay()
        for (fn, attr), n in self.launches[name]:
            setattr(fn, attr, getattr(fn, attr) + n)
        for key, n in self.cards[name].items():
            kernels.LAUNCHES[key] = kernels.LAUNCHES.get(key, 0) + n
        if name in self.moved:
            self.comm.stats.replayed(*self.moved[name])

    def replay_ms(self, names, reps: int = 50) -> dict:
        """Milliseconds of one replay of each named graph, over ``reps``
        replays back to back after one more, every card synchronized (a
        measurement: the replays overwrite the solve's state, and those of
        a segment with collectives must be made alike on every rank)."""
        def sync():
            for d in [self.device] + self.others:
                torch.cuda.synchronize(d)
        out = {}
        for name in names:
            g = self.graphs[name]
            g.replay()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                g.replay()
            sync()
            out[name] = (time.perf_counter() - t0) * 1e3 / reps
        return out

    def _capture(self) -> None:
        # No automatic collection during the capture: an earlier solve's
        # graphs that wait in a reference cycle (a finished Simulation's)
        # would be reset by the collector in the middle of it, which ends
        # the capture (cudaErrorStreamCaptureInvalidated, seen on the H100
        # in the third 216-atom run of one process).
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._capture_all()
        finally:
            if collecting:
                gc.enable()

    def _capture_all(self) -> None:
        cards = [self.device] + self.others
        sides = {}
        for d in cards:
            if d not in Segments._side_streams:
                Segments._side_streams[d] = torch.cuda.Stream(d)
            sides[d] = Segments._side_streams[d]
        # a process group's watchdog thread queries its events during the
        # capture, which the default (global) mode would forbid
        mode = ("thread_local" if self.comm is not None and self.comm.W > 1
                else "global")
        counts = lambda: [getattr(fn, attr) for fn, attr in COUNTERS]
        with torch.cuda.device(self.device):
            before = counts()
            for d in cards:
                sides[d].wait_stream(torch.cuda.current_stream(d))
            with _streams(sides, self.device):
                for fn in self.fns.values():
                    fn()
            for d in cards:
                torch.cuda.current_stream(d).wait_stream(sides[d])
            self.warmup = {attr: n - b for (_, attr), n, b
                           in zip(COUNTERS, counts(), before)}
            pool = torch.cuda.graph_pool_handle()
            for d in self.others:
                with torch.cuda.device(d):
                    self.pools[d] = torch.cuda.MemPool()
            graphs = {}
            for name, fn in self.fns.items():
                g = torch.cuda.CUDAGraph()
                t0 = perf_counter_ns()
                with _streams(sides, self.device), ExitStack() as routed:
                    for d in self.others:
                        routed.enter_context(
                            torch.cuda.use_mem_pool(self.pools[d], d))
                    g.capture_begin(pool=pool, capture_error_mode=mode)
                    try:
                        with _taken_back(self.comm) as taken:
                            for d in self.others:         # fork
                                sides[d].wait_stream(sides[self.device])
                            fn()
                            for d in self.others:         # join
                                sides[self.device].wait_stream(sides[d])
                    finally:
                        t1 = perf_counter_ns()
                        g.capture_end()
                self.capture_s += (t1 - t0) * 1e-9
                self.instantiate_s += (perf_counter_ns() - t1) * 1e-9
                self.launches[name] = taken["launches"]
                self.cards[name] = taken["cards"]
                if taken["moved"][0]:
                    self.moved[name] = taken["moved"]
                graphs[name] = g
            for d in cards:
                torch.cuda.synchronize(d)
        self.graphs = graphs

    def release(self) -> None:
        """Drop the graphs, whose memory pools go back to the allocator,
        and the segments' functions: their solver refers to this object,
        and without the cycle it is freed (operators and all) as soon as
        its owner drops it."""
        for g in (self.graphs or {}).values():
            g.reset()
        self.graphs = None
        self.pools = {}
        self.fns = {}


@contextmanager
def _taken_back(comm):
    """Take back, on leaving the block, what the kernel wrappers (their
    counters and kernels.LAUNCHES) and ``comm``'s collectives (its
    ``stats``) counted inside it, into the yielded dict: ``launches``
    [(counter, n)], ``cards`` {(kernel, card): n} and ``moved`` (calls,
    bytes) by kind.  A capture runs nothing; each replay adds them."""
    counts = [getattr(fn, attr) for fn, attr in COUNTERS]
    cards = dict(kernels.LAUNCHES)
    stats = comm.stats if comm is not None else None
    if stats is not None:
        comm.stats = type(stats)()
    taken = {}
    try:
        yield taken
    finally:
        taken["launches"] = [((fn, attr), getattr(fn, attr) - n)
                             for (fn, attr), n in zip(COUNTERS, counts)
                             if getattr(fn, attr) != n]
        for (fn, attr), n in zip(COUNTERS, counts):
            setattr(fn, attr, n)
        taken["cards"] = {k: n - cards.get(k, 0)
                          for k, n in kernels.LAUNCHES.items()
                          if n != cards.get(k, 0)}
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(cards)
        taken["moved"] = ({}, {})
        if stats is not None:
            moved, comm.stats = comm.stats, stats
            taken["moved"] = (moved.calls, moved.bytes)


@contextmanager
def _streams(sides: dict, first: torch.device):
    """Make each card's stream in ``sides`` its current stream, ``first``
    the current device; restore both after."""
    device = torch.cuda.current_device()
    prev = [torch.cuda.current_stream(d) for d in sides]
    try:
        for d, s in sides.items():
            if d != first:
                torch.cuda.set_stream(s)
        torch.cuda.set_stream(sides[first])
        yield
    finally:
        for s in prev:
            torch.cuda.set_stream(s)
        torch.cuda.set_device(device)


class CoarseCG:
    """A preconditioned CG from zero as state, ``start`` and ``step``: the
    coarse solves inside a V-cycle, solver/gmg.py:coarse_cg (Chebyshev) and
    parallel/sharded_gmg.py:_jacobi_cg (Jacobi), with their stopping test
    in float64 as the eager loops make it (``r2 > rtol^2 r2_0`` and ``k <
    maxiter``).  ``info`` holds (active, k) for one read."""

    def __init__(self, mv: Callable, precond: Callable, n: int, rtol: float,
                 maxiter: int, dtype, device):
        self.mv, self.precond = mv, precond
        self.rtol2 = rtol ** 2
        self.maxiter = maxiter
        self.x, self.r, self.p = (torch.zeros(n, dtype=dtype, device=device)
                                  for _ in range(3))
        self.rho, self.r2 = (torch.zeros((), dtype=dtype, device=device)
                             for _ in range(2))
        self.tol2 = torch.zeros((), dtype=torch.float64, device=device)
        self.k = torch.zeros((), dtype=torch.int32, device=device)
        self.active = torch.zeros((), dtype=torch.bool, device=device)
        self.info = torch.zeros(2, dtype=torch.int32, device=device)

    def start(self, d0: torch.Tensor) -> None:
        r2 = torch.dot(d0, d0)
        z = self.precond(d0)
        self.x.zero_()
        self.r.copy_(d0)
        self.tol2.copy_(r2.double() * self.rtol2)
        self.p.copy_(z)
        self.rho.copy_(torch.dot(d0, z))
        self.r2.copy_(r2)
        self.k.zero_()
        self._test()

    def step(self) -> None:
        q = self.mv(self.p)
        alpha = _safe_div(self.rho, torch.dot(self.p, q))
        self.x.copy_(self.x + alpha * self.p)
        r = self.r - alpha * q
        z = self.precond(r)
        rho = torch.dot(r, z)
        self.p.copy_(z + _safe_div(rho, self.rho) * self.p)
        self.r.copy_(r)
        self.rho.copy_(rho)
        self.r2.copy_(torch.dot(r, r))
        self.k.add_(1)
        self._test()

    def _test(self) -> None:
        self.active.copy_((self.r2.double() > self.tol2)
                          & (self.k < self.maxiter))
        self.info.copy_(torch.stack([self.active.int(), self.k]))


class SteppedGMG:
    """:func:`~coulomb_gmg_tpu_torch.solver.gmg.gmg_cg` on one operator set
    as device state and segments; :meth:`solve` has its contract and its
    bits.  Host reads per solve: ``k + 1`` of ``info``, plus, without the
    DST, ``kc + 1`` of the coarse flag for each V-cycle with kc coarse
    iterations (the eager loop: ``k + 1``, plus ``kc + 2`` per
    V-cycle)."""

    def __init__(self, ops: dict, n_pad: int, dtype, device):
        dev = torch.device(device)
        self.ops = ops
        self.dtype = dtype
        vec = lambda n: torch.zeros(n, dtype=dtype, device=dev)
        scalar = lambda dt: torch.zeros((), dtype=dt, device=dev)
        self.rhs, self.x, self.r, self.p = (vec(n_pad) for _ in range(4))
        self.rho, self.res2, self.res0_2, self.tol2 = (scalar(dtype)
                                                       for _ in range(4))
        self.k, self.maxiter = scalar(torch.int32), scalar(torch.int32)
        self.active = scalar(torch.bool)
        self.info = torch.zeros(4, dtype=torch.float64, device=dev)
        if ops["dst"] is not None:
            self.coarse = None
            fns = {"start": self._start, "step": self._step}
        else:
            nl = [lv["inv_diag"].shape[0] for lv in ops["levels"]]
            self.defect = [vec(n) for n in nl]
            self.sol = [vec(n) for n in nl[1:]]
            lv0 = ops["levels"][0]
            self.coarse = CoarseCG(lambda v: ell_mv(*lv0["A"], v),
                                   lambda r: _smooth(lv0, r, None, True),
                                   nl[0], ops["coarse_rtol"],
                                   ops["coarse_maxiter"], dtype, dev)
            fns = {"start_head": self._start_head,
                   "start_tail": self._start_tail,
                   "step_head": self._step_head,
                   "step_tail": self._step_tail,
                   "coarse": self.coarse.step}
        self.segments = Segments(fns, dev)

    def solve(self, rhs: torch.Tensor, x0: torch.Tensor, tol: float,
              maxiter: int):
        """GMG-CG until ``|r| <= tol`` or ``maxiter`` iterations.  Returns
        (x, iterations, |r0|, |r|), the norms floats."""
        self.segments.prepare()
        self.rhs.copy_(rhs)
        self.x.copy_(x0)
        self.tol2.copy_(tol_squared(tol, self.dtype))
        self.maxiter.fill_(maxiter)
        run = self.segments.run
        if self.coarse is None:
            run("start")
        else:
            run("start_head")
            self._coarse_loop()
            run("start_tail")
        while True:
            active, k, res0_2, res2 = to_host(self.info)
            if not active:
                break
            if self.coarse is None:
                run("step")
            else:
                run("step_head")
                self._coarse_loop()
                run("step_tail")
        return self.x.clone(), int(k), res0_2 ** 0.5, res2 ** 0.5

    def release(self) -> None:
        self.segments.release()

    # ------------------------------------------------------------ pieces

    def _coarse_loop(self) -> None:
        while to_host(self.coarse.active):
            self.segments.run("coarse")

    def _residual(self) -> torch.Tensor:
        r = self.rhs - sys_mv(self.ops["sys"], self.x)
        res2 = torch.dot(r, r)
        self.r.copy_(r)
        self.res2.copy_(res2)
        self.res0_2.copy_(res2)
        return r

    def _first_direction(self, r: torch.Tensor, z: torch.Tensor) -> None:
        self.p.copy_(z)
        self.rho.copy_(torch.dot(r, z))
        self.k.zero_()
        self._test()

    def _update(self) -> torch.Tensor:
        """x and r of one CG iteration; returns the new r."""
        q = sys_mv(self.ops["sys"], self.p)
        alpha = _safe_div(self.rho, torch.dot(self.p, q))
        self.x.copy_(self.x + alpha * self.p)
        r = self.r - alpha * q
        self.r.copy_(r)
        return r

    def _finish(self, r: torch.Tensor, z: torch.Tensor) -> None:
        rho = torch.dot(r, z)
        self.p.copy_(z + _safe_div(rho, self.rho) * self.p)
        self.rho.copy_(rho)
        self.res2.copy_(torch.dot(r, r))
        self.k.add_(1)
        self._test()

    def _test(self) -> None:
        """The stopping test of gmg_cg, in the working type."""
        self.active.copy_((self.k < self.maxiter) & (self.res2 > self.tol2))
        self.info.copy_(torch.stack([self.active.double(), self.k.double(),
                                     self.res0_2.double(),
                                     self.res2.double()]))

    # ---------------------------------------- with the DST: two segments

    def _start(self) -> None:
        r = self._residual()
        self._first_direction(r, vcycle(self.ops, r))

    def _step(self) -> None:
        r = self._update()
        self._finish(r, vcycle(self.ops, r))

    # ------------------------------------- with the coarse CG: five segments

    def _down(self, r: torch.Tensor) -> None:
        defect, sol = vcycle_down(self.ops, r)
        for buf, d in zip(self.defect, defect):
            buf.copy_(d)
        for buf, s in zip(self.sol, sol[1:]):
            buf.copy_(s)
        self.coarse.start(self.defect[0])

    def _up(self) -> torch.Tensor:
        return vcycle_up(self.ops, self.defect, [self.coarse.x] + self.sol,
                         self.r)

    def _start_head(self) -> None:
        self._down(self._residual())

    def _start_tail(self) -> None:
        self._first_direction(self.r, self._up())

    def _step_head(self) -> None:
        self._down(self._update())

    def _step_tail(self) -> None:
        self._finish(self.r, self._up())


class SteppedCG:
    """solver/cg.py:cg's arithmetic as device state over per-shard lists
    and two segments, in the order of JAX's ``cg(host=False)`` and of the
    sharded ``while_loop``: the preconditioner right after the update (the
    eager loops apply it at the head of the next iteration: the same
    values, and one application more after the last test).

    ``mv`` and ``precond`` map a per-shard list to a per-shard list;
    ``dot(a, b)`` gives the global ``a . b`` once per shard, on its device;
    ``norm(a)`` the global ``|a|`` on the first shard's device.  On
    several cards the segments are graphs over all of them; ``comm`` is
    the ``SpmdContext`` whose collectives they call (:class:`Segments`).
    ``dealii``: the stopping rule of solver/cg.py (iterate if ``res0 >=
    tol``, stop once ``res < tol`` or ``k >= maxiter``); else the while
    loop's (iterate while ``res >= tol`` and ``k < maxiter``).  Host reads
    per solve: ``k + 1``."""

    def __init__(self, mv: Callable, precond: Callable, dot: Callable,
                 norm: Callable, like: list, *, dealii: bool = False,
                 capture: Optional[bool] = None, comm=None):
        self.mv, self.precond, self.dot, self.norm = mv, precond, dot, norm
        self.dealii = dealii
        zeros = lambda: [torch.zeros_like(v) for v in like]
        self.rhs, self.x, self.r, self.p = zeros(), zeros(), zeros(), zeros()
        self.rho = [torch.zeros((), dtype=v.dtype, device=v.device)
                    for v in like]
        dev = like[0].device
        scalar = lambda dt: torch.zeros((), dtype=dt, device=dev)
        self.res0, self.res = scalar(like[0].dtype), scalar(like[0].dtype)
        self.tol = scalar(torch.float64)
        self.k, self.maxiter = scalar(torch.int32), scalar(torch.int32)
        self.active = scalar(torch.bool)
        self.info = torch.zeros(4, dtype=torch.float64, device=dev)
        self.segments = Segments({"start": self._start, "step": self._step},
                                 dev, capture, [v.device for v in like],
                                 comm)

    def solve(self, rhs: list, x0: list, tol: float,
              maxiter: int) -> CGResult:
        """CG from ``x0`` (per-shard lists); returns the solution as a
        per-shard list of copies."""
        self.segments.prepare()
        _assign(self.rhs + self.x, list(rhs) + list(x0))
        self.tol.fill_(tol)
        self.maxiter.fill_(maxiter)
        self.segments.run("start")
        while True:
            active, k, res0, res = to_host(self.info)
            if not active:
                break
            self.segments.run("step")
        return CGResult(x=[x.clone() for x in self.x], iterations=int(k),
                        initial_residual=res0, final_residual=res)

    def release(self) -> None:
        self.segments.release()

    def _start(self) -> None:
        r = [b - y for b, y in zip(self.rhs, self.mv(self.x))]
        res = self.norm(r)
        z = self.precond(r)
        _assign(self.r, r)
        _assign(self.p, z)
        _assign(self.rho, self.dot(r, z))
        self.res0.copy_(res)
        self.res.copy_(res)
        self.k.zero_()
        go = res.double() >= self.tol
        self.active.copy_(go if self.dealii else go & (self.k < self.maxiter))
        self._info()

    def _step(self) -> None:
        q = self.mv(self.p)
        alpha = [a / b for a, b in zip(self.rho, self.dot(self.p, q))]
        x = [xi + a * pi for xi, a, pi in zip(self.x, alpha, self.p)]
        r = [ri - a * qi for ri, a, qi in zip(self.r, alpha, q)]
        res = self.norm(r)
        z = self.precond(r)
        rho = self.dot(r, z)
        p = [zi + (a / b) * pi for zi, a, b, pi in zip(z, rho, self.rho,
                                                         self.p)]
        for buf, v in ((self.x, x), (self.r, r), (self.p, p),
                       (self.rho, rho)):
            _assign(buf, v)
        self.res.copy_(res)
        self.k.add_(1)
        go = ~(res.double() < self.tol) if self.dealii \
            else res.double() >= self.tol
        self.active.copy_(go & (self.k < self.maxiter))
        self._info()

    def _info(self) -> None:
        self.info.copy_(torch.stack([self.active.double(), self.k.double(),
                                     self.res0.double(), self.res.double()]))


def _assign(bufs: list, values: list) -> None:
    for b, v in zip(bufs, values):
        b.copy_(v)


def stepped_cg(apply_A: Callable, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None, *, precond: Callable,
               tol: float, maxiter: int) -> CGResult:
    """solver/cg.py:cg (its contract and its bits) as a stepped solve on
    ``b``'s device, JAX's ``cg(host=False)``: on the card CUDA graphs,
    captured for this call and released after it."""
    one = lambda f: (lambda v: [f(v[0])])
    s = SteppedCG(one(apply_A), one(precond),
                  lambda u, v: [torch.dot(u[0], v[0])],
                  lambda v: torch.linalg.vector_norm(v[0]), [b], dealii=True)
    try:
        res = s.solve([b], [torch.zeros_like(b) if x0 is None else x0], tol,
                      maxiter)
    finally:
        s.release()
    return res._replace(x=res.x[0])
