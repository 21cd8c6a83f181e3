"""Sharded GMG-preconditioned CG over the shards of an SpmdContext.

Counterpart of coulomb_gmg_tpu/parallel/sharded_gmg.py, the reference's
distributed multigrid (every level row-partitioned across ranks, ghost
imports before each operator application, scalar all-reduces inside CG, a
coarse solve; src/step-50.cc:722-731, 938-1017, 962-967):

* every level vector is a list of per-shard ``(block_l,)`` tensors;
* every level, interface, prolongation, restriction and copy operator is a
  per-shard ELL (parallel/sharded.py) applied by the ELL kernel; the
  operators that read one vector share one :class:`HaloPlan` (per level:
  A, A_if, A_if^T, the restriction to the coarser level, the prolongation
  to the finer one and the copy back to the global vector; for the global
  vector: the system and the copies to every level).  The copies are
  1-slot ELLs of unit weights (value 0 where a row takes nothing); the
  copy back is their sum over the levels, each global row taking its
  value from exactly one level;
* Chebyshev-over-Jacobi smoothing with spectra estimated on the host (a
  15-step power iteration, as the JAX module does);
* CG dot products are per-shard partials summed by ``SpmdContext.psum``;
* the coarse problem: the JAX module solves it redundantly on every device
  by Jacobi-preconditioned CG on the row-partitioned level-0 operator.
  Here level 0's defect is gathered and the same CG runs ONCE PER DISTINCT
  PHYSICAL DEVICE on the whole level-0 operator, each shard taking its own
  block of the result: shards that share a device (the one-card runs) do
  not repeat it.  Across processes each rank gathers the level-0 defect
  and solves it redundantly, as JAX solves it on every device
  (coulomb_gmg_tpu/parallel/sharded.py:16-17).

Across processes (an ``SpmdContext`` with a process group) every rank
builds the host plans of all D shards from the same operators and keeps
the ELLs of its own shards; :meth:`ShardedGMG.solve_global` returns the
local blocks and :meth:`ShardedGMG.solve` the full solution on every rank.

The solve has two forms.  The JAX module runs it as one shard_map
executable, the outer CG and the coarse CG inside every V-cycle each a
``lax.while_loop``.  With ``fused=True`` (the driver's ``solve_fused``,
the default) the port runs it as device state and five segments
(:class:`_SteppedShardedGMG`, on solver/fused.py's ``Segments``): up to
the level-0 defect and the coarse start, one coarse iteration, the rest
of the start, and the head and tail of a CG step around the coarse loop.
The host reads the solve's state before every step and the coarse CG's
(active, k) before every coarse iteration: ``k + 1 + sum(kc + 1)`` reads
for k CG steps and k + 1 V-cycles of kc coarse iterations each.  When
every local shard is on one card of one process the segments are CUDA
graphs, captured at the first solve and kept until ``release()``;
across cards or processes they run uncaptured, one call a replay
(``SpmdContext.graph_mode``; ``solve_info()`` says which).
``fused=False`` runs the eager loops: host loops that read the same
scalars as they go, through solver/cg.py:to_host.  Both forms give the
same bits.  The JAX module's padded all_to_all tables and its pow2
buckets have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import SlicedELL, ell_mv
from coulomb_gmg_tpu_torch.ops.spmv import transpose_pattern
from coulomb_gmg_tpu_torch.parallel.sharded import (
    HaloPlan, apply_ells, block_coo, halo_import, round_up, shard_ells)
from coulomb_gmg_tpu_torch.solver.cg import to_host
from coulomb_gmg_tpu_torch.solver.fused import CoarseCG, Segments, _assign
from coulomb_gmg_tpu_torch.solver.gmg import _safe_div
from coulomb_gmg_tpu_torch.solver.tpu_gmg import _power_lmax


def _coo(csr, transpose: bool = False):
    """(rowids, cols, values) of a port CSR (or of its transpose) in row
    order, columns ascending within a row."""
    data = csr.data_np()
    if not transpose:
        return csr.rowids, csr.indices, data
    indptr, indices, perm = transpose_pattern(csr.indptr, csr.indices,
                                              csr.n_cols)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return rows, indices, data[perm]


def _shared(ctx, src_block: int, specs, dtype, halo: bool):
    """Per-shard ELLs of several operators reading one source vector.

    specs: (rowids, cols, values, row_block) global COO per operator.
    Returns (plan, [per-operator per-shard ELL list])."""
    D = ctx.D
    parts = [block_coo(r, c, v, blk, D) for r, c, v, blk in specs]
    cols = [np.concatenate([p[1][d] for p in parts]) for d in range(D)]
    plan = HaloPlan.build(cols, src_block, D, halo)
    out, off = [], [0] * D
    for (rows, cs, vals), (_, _, _, blk) in zip(parts, specs):
        local = []
        for d in range(D):
            n = len(cs[d])
            local.append(plan.cols_local[d][off[d]: off[d] + n])
            off[d] += n
        out.append(shard_ells(rows, local, vals, blk, ctx, dtype))
    return plan, out


@dataclass
class _Level:
    block: int
    inv_diag: list                   # per shard (block,)
    theta: float
    delta: float
    plan: HaloPlan = None            # ghosts of a level-l vector
    A: list = None
    iface: Optional[list] = None
    ifaceT: Optional[list] = None
    R: Optional[list] = None         # rows on level l - 1
    P: Optional[list] = None         # rows on level l + 1
    copy_to: list = None             # rows on level l, reads the global
    copy_from: list = None           # rows global, reads level l


class ShardedGMG:
    """Sharded GMG-CG, its operators built on the host (the JAX
    ``ShardedGMG``; the SpmdContext takes the place of its device mesh).
    ``fused``: the stepped solve (module docstring), else the eager
    loops."""

    def __init__(self, gmg, sys_csr, ctx, dtype: torch.dtype = torch.float32,
                 smoother_degree: int = 4, smoothing_range: float = 8.0,
                 coarse_maxiter: int = 500, coarse_rtol: float = 1e-10,
                 maxiter: int = 50, halo: bool = True, fused: bool = True):
        self.ctx = ctx
        self.fused = fused
        self.stepped = None
        self._info = {}
        self.D = D = ctx.D
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.degree = smoother_degree
        self.coarse_maxiter = coarse_maxiter
        self.coarse_rtol = coarse_rtol
        self.maxiter = maxiter
        self.coarse_iterations = []      # the coarse CG's, per V-cycle
        self.n = n = sys_csr.n_rows
        self.n_pad = round_up(max(n, D), D)
        self.block = self.n_pad // D
        cast = lambda coo: (coo[0], coo[1], coo[2].astype(self.np_dtype))

        # ---- levels: diagonal, spectrum, and the operators reading a
        # level-l vector
        self.levels: List[_Level] = []
        blocks = [round_up(max(A.n_rows, D), D) // D for A in gmg.matrices]
        L = len(gmg.matrices) - 1
        src_lvl = np.full(n, -1, np.int64)
        src_idx = np.zeros(n, np.int64)
        for l in range(L + 1):
            src_lvl[gmg.copy_global[l]] = l
            src_idx[gmg.copy_global[l]] = gmg.copy_level[l]
        for l, A in enumerate(gmg.matrices):
            nl, blk = A.n_rows, blocks[l]
            data = A.data_np().astype(self.np_dtype)
            diag = np.zeros(blk * D, self.np_dtype)
            sel = A.rowids == A.indices
            diag[A.rowids[sel]] = data[sel]
            diag[diag == 0] = 1.0
            inv = (1.0 / diag).astype(self.np_dtype)
            lmax = (_power_lmax(A, inv, nl) * 1.05 if l > 0 and nl > 1
                    else 2.0)     # level 0 is solved by the coarse CG
            lmin = lmax / smoothing_range
            if l == 0:
                inv0 = inv
            lv = _Level(block=blk,
                        inv_diag=[torch.from_numpy(inv[d * blk:(d + 1) * blk]
                                                   ).to(dev)
                                  for d, dev in zip(ctx.shards,
                                                    ctx.devices)],
                        theta=float(self.np_dtype(0.5 * (lmax + lmin))),
                        delta=float(self.np_dtype(0.5 * (lmax - lmin))))
            specs, names = [(*cast(_coo(A)), blk)], ["A"]
            I = gmg.interfaces[l]
            if I is not None:
                specs += [(*cast(_coo(I)), blk), (*cast(_coo(I, True)), blk)]
                names += ["iface", "ifaceT"]
            if l > 0:
                specs.append((*cast(_coo(gmg.prolongations[l], True)),
                              blocks[l - 1]))
                names.append("R")
            if l < L:
                specs.append((*cast(_coo(gmg.prolongations[l + 1])),
                              blocks[l + 1]))
                names.append("P")
            rows = np.flatnonzero(src_lvl == l)
            specs.append((rows, src_idx[rows],
                          np.ones(len(rows), self.np_dtype), self.block))
            names.append("copy_from")
            lv.plan, ells = _shared(ctx, blk, specs, dtype, halo)
            for name, e in zip(names, ells):
                setattr(lv, name, e)
            self.levels.append(lv)

        # ---- the operators reading the global vector: the system and the
        # copies to every level (copy_to_mg)
        specs = [(*cast(_coo(sys_csr)), self.block)]
        for l in range(L + 1):
            specs.append((gmg.copy_level[l], gmg.copy_global[l],
                          np.ones(len(gmg.copy_level[l]), self.np_dtype),
                          blocks[l]))
        self.sys_plan, ells = _shared(ctx, self.block, specs, dtype, halo)
        self.sys = ells[0]
        for lv, e in zip(self.levels, ells[1:]):
            lv.copy_to = e

        # ---- the whole level-0 operator once per distinct local device
        # (coarse)
        e0 = SlicedELL.from_coo(*cast(_coo(gmg.matrices[0])),
                                self.levels[0].block * D)
        inv0 = torch.from_numpy(inv0)
        self._coarse_ops = {dev: (e0.device(dev, dtype), inv0.to(dev))
                            for dev in ctx.unique_devices}

    # ------------------------------------------------------------------

    def _pdot(self, a, b) -> list:
        return self.ctx.psum([torch.dot(x, y) for x, y in zip(a, b)])

    def _amv(self, lv: _Level, v: list) -> list:
        return apply_ells(lv.A, halo_import(v, lv.plan, self.ctx))

    def _cheb(self, lv: _Level, d: list, x0: Optional[list],
              from_zero: bool) -> list:
        """Chebyshev iteration on [theta - delta, theta + delta] of
        D^{-1} A (solver/gmg.py:cheb, per shard)."""
        if from_zero:
            r = [m * di for m, di in zip(lv.inv_diag, d)]
        else:
            r = [m * (di - y) for m, di, y in zip(lv.inv_diag, d,
                                                   self._amv(lv, x0))]
        p = [ri / lv.theta for ri in r]
        x = p if from_zero else [xi + pi for xi, pi in zip(x0, p)]
        sigma = lv.theta / lv.delta
        rho_old = 1.0 / sigma
        for _ in range(self.degree - 1):
            r = [m * (di - y) for m, di, y in zip(lv.inv_diag, d,
                                                   self._amv(lv, x))]
            rho = 1.0 / (2.0 * sigma - rho_old)
            p = [rho * rho_old * pi + (2.0 * rho / lv.delta) * ri
                 for pi, ri in zip(p, r)]
            x = [xi + pi for xi, pi in zip(x, p)]
            rho_old = rho
        return x

    def _coarse_solve(self, d0: list) -> list:
        """Jacobi-preconditioned CG on the gathered level-0 defect to
        ``coarse_rtol`` (relative) or ``coarse_maxiter`` iterations, once
        per distinct local device; each shard takes its block."""
        ctx = self.ctx
        full = ctx.all_gather(d0, "coarse")
        sol = {}
        for i, dev in enumerate(ctx.devices):
            if dev not in sol:
                (cols, vals), inv = self._coarse_ops[dev]
                sol[dev], k = _jacobi_cg(cols, vals, inv, full[i],
                                         self.coarse_rtol,
                                         self.coarse_maxiter)
        self.coarse_iterations.append(k)
        return self._coarse_blocks(sol)

    def _coarse_blocks(self, sol: dict) -> list:
        """Each local shard's block of the coarse solution ``sol[device]``."""
        blk = self.levels[0].block
        return [sol[dev][d * blk:(d + 1) * blk]
                for d, dev in zip(self.ctx.shards, self.ctx.devices)]

    def vcycle(self, g: list) -> list:
        """One V-cycle on the per-shard global defect ``g``."""
        defect, sol = self._down(g)
        sol[0] = self._coarse_solve(defect[0])
        return self._up(defect, sol)

    def _down(self, g: list):
        """The first half of a V-cycle: copy ``g`` to the levels,
        pre-smooth and restrict down to level 0.  Returns (defect per
        level, smoothed solution per level, None at 0)."""
        ctx, levels = self.ctx, self.levels
        L = len(levels) - 1
        gext = halo_import(g, self.sys_plan, ctx)
        defect = [apply_ells(lv.copy_to, gext) for lv in levels]
        sol = [None] * (L + 1)
        for l in range(L, 0, -1):
            lv = levels[l]
            u = self._cheb(lv, defect[l], None, True)
            uext = halo_import(u, lv.plan, ctx)
            r = [di - y for di, y in zip(defect[l], apply_ells(lv.A, uext))]
            if lv.iface is not None:
                r = [ri - y for ri, y in zip(r, apply_ells(lv.iface, uext))]
            rext = halo_import(r, lv.plan, ctx)
            defect[l - 1] = [a + b for a, b in zip(
                defect[l - 1], apply_ells(lv.R, rext))]
            sol[l] = u
        return defect, sol

    def _up(self, defect: list, sol: list) -> list:
        """The second half: prolongate from the coarse solution ``sol[0]``,
        post-smooth and copy back to the global layout."""
        ctx, levels = self.ctx, self.levels
        for l in range(1, len(levels)):
            lv, lc = levels[l], levels[l - 1]
            cext = halo_import(sol[l - 1], lc.plan, ctx)
            u = [s + y for s, y in zip(sol[l], apply_ells(lc.P, cext))]
            d = defect[l]
            if lv.ifaceT is not None:
                uext = halo_import(u, lv.plan, ctx)
                d = [di - y for di, y in zip(d, apply_ells(lv.ifaceT, uext))]
            sol[l] = self._cheb(lv, d, u, False)
        out = None
        for l, lv in enumerate(levels):
            part = apply_ells(lv.copy_from, halo_import(sol[l], lv.plan, ctx))
            out = part if out is None else [a + b for a, b in zip(out, part)]
        return out

    def _sys_mv(self, v: list) -> list:
        return apply_ells(self.sys, halo_import(v, self.sys_plan, self.ctx))

    def _norm(self, v: list) -> torch.Tensor:
        return torch.sqrt(self._pdot(v, v)[0])

    # ------------------------------------------------------------------

    def solve_global(self, rhs, x0=None, rtol: float = 1e-8):
        """Sharded solve: returns (x as per-local-shard blocks, iters,
        |r0|, |r|)."""
        ctx = self.ctx
        b = np.zeros(self.n_pad, self.np_dtype)
        b[: self.n] = np.asarray(rhs, self.np_dtype)
        x0p = np.zeros(self.n_pad, self.np_dtype)
        if x0 is not None:
            x0p[: self.n] = np.asarray(x0, self.np_dtype)
        tol = float(self.np_dtype(rtol * np.linalg.norm(b)))
        blk = self.block
        put = lambda a: [torch.from_numpy(a[d * blk:(d + 1) * blk]).to(dev)
                         for d, dev in zip(ctx.shards, ctx.devices)]
        reads = to_host.reads
        if not self.fused:
            out = self._eager_cg(put(b), put(x0p), tol)
            self._info = {"mode": "eager: host loops"}
        else:
            if self.stepped is None:
                self.stepped = _SteppedShardedGMG(self)
            seg = self.stepped.segments
            fresh = seg.graphs is None
            out = self.stepped.solve(put(b), put(x0p), tol)
            fresh = fresh and seg.graphs is not None
            self._info = {"mode": self.stepped.mode,
                          "capture_s": seg.capture_s if fresh else 0.0,
                          "instantiate_s": (seg.instantiate_s if fresh
                                            else 0.0),
                          "warmup": dict(seg.warmup) if fresh else {}}
        self._info["reads"] = to_host.reads - reads
        return out

    def _eager_cg(self, bs: list, x: list, tol: float):
        r = [bi - y for bi, y in zip(bs, self._sys_mv(x))]
        res0 = to_host(self._norm(r))
        z = self.vcycle(r)
        p = z
        rho = self._pdot(r, z)
        res, k = res0, 0
        while res > tol and k < self.maxiter:
            q = self._sys_mv(p)
            alpha = [_safe_div(a, b) for a, b in zip(rho, self._pdot(p, q))]
            x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
            r = [ri - a * qi for ri, a, qi in zip(r, alpha, q)]
            res = to_host(self._norm(r))
            z = self.vcycle(r)
            rho_new = self._pdot(r, z)
            p = [zi + _safe_div(a, b) * pi
                 for zi, a, b, pi in zip(z, rho_new, rho, p)]
            rho = rho_new
            k += 1
        return x, k, res0, res

    def solve(self, rhs, x0=None, rtol: float = 1e-8):
        """numpy in / numpy out, the full solution on every rank; returns
        (x (n,) float64, iters, |r0|, |r|)."""
        xb, k, res0, res = self.solve_global(rhs, x0, rtol)
        x = self.ctx.all_gather(xb)[0].cpu().numpy()[: self.n]
        return x.astype(np.float64), k, res0, res

    def solve_info(self) -> dict:
        """How the last solve ran: ``mode`` (the form, and for the stepped
        one whether its segments are CUDA graphs, and why) and ``reads``
        (its host reads); for the stepped form also the seconds of the
        capture and instantiation that this solve made, and the warm-up
        launches before it (none when the graphs existed already, or
        when the segments run uncaptured)."""
        return dict(self._info)

    def release(self) -> None:
        """Drop the stepped solve's graphs and state (the next solve makes
        them anew)."""
        if self.stepped is not None:
            self.stepped.release()
            self.stepped = None


class _SteppedShardedGMG:
    """:meth:`ShardedGMG.solve_global`'s loops as device state and
    segments, op for op the eager loops' arithmetic, stopping tests
    included: the outer ``res > tol`` (``res = sqrt(psum(r . r))`` in the
    working type against ``tol`` rounded to it, compared in float64) and
    ``k < maxiter``; the coarse ``r2 > rtol^2 r2_0`` in float64
    (solver/fused.py:CoarseCG).  The per-shard state lives on the shards'
    devices, the solve's scalars on the first; the coarse CG's state once
    per distinct local device, as ``_coarse_solve`` runs it.  Like the
    eager loop, the step runs a V-cycle after the last residual test."""

    def __init__(self, sg: ShardedGMG):
        ctx = sg.ctx
        self.sg = sg
        capture, self.mode = ctx.graph_mode()
        dt = sg.dtype
        vecs = lambda n: [torch.zeros(n, dtype=dt, device=dev)
                          for dev in ctx.devices]
        self.rhs, self.x, self.r, self.p = (vecs(sg.block) for _ in range(4))
        self.rho = [torch.zeros((), dtype=dt, device=dev)
                    for dev in ctx.devices]
        dev0 = ctx.devices[0]
        scalar = lambda t: torch.zeros((), dtype=t, device=dev0)
        self.res0, self.res = scalar(dt), scalar(dt)
        self.tol = scalar(torch.float64)
        self.k, self.maxiter = scalar(torch.int32), scalar(torch.int32)
        self.active = scalar(torch.bool)
        self.info = torch.zeros(4, dtype=torch.float64, device=dev0)
        self.defect = [vecs(lv.block) for lv in sg.levels]
        self.sol = [vecs(lv.block) for lv in sg.levels[1:]]
        n0 = sg.levels[0].block * sg.D
        self.coarse = {
            dev: CoarseCG(lambda v, e=e: ell_mv(*e, v),
                          lambda r, m=inv: m * r, n0, sg.coarse_rtol,
                          sg.coarse_maxiter, dt, dev)
            for dev, (e, inv) in sg._coarse_ops.items()}
        self.coarse0 = self.coarse[dev0]
        # the import index sets exist before any capture: no copy from
        # the host inside a segment
        for plan in [sg.sys_plan] + [lv.plan for lv in sg.levels]:
            if not plan.gather:
                plan.routes(ctx)
        self.segments = Segments({"start_head": self._start_head,
                                  "start_tail": self._start_tail,
                                  "step_head": self._step_head,
                                  "step_tail": self._step_tail,
                                  "coarse": self._coarse_step},
                                 dev0, capture)

    def solve(self, bs: list, x0: list, tol: float):
        self.segments.prepare()
        _assign(self.rhs + self.x, bs + x0)
        self.tol.fill_(tol)
        self.maxiter.fill_(self.sg.maxiter)
        run = self.segments.run
        run("start_head")
        self._coarse_loop()
        run("start_tail")
        while True:
            active, k, res0, res = to_host(self.info)
            if not active:
                break
            run("step_head")
            self._coarse_loop()
            run("step_tail")
        return [x.clone() for x in self.x], int(k), res0, res

    def release(self) -> None:
        self.segments.release()

    def _coarse_loop(self) -> None:
        """Coarse iterations while the first device's coarse CG is active
        (every device's computes the same bits); its k goes to
        ``coarse_iterations``."""
        while True:
            active, k = to_host(self.coarse0.info)
            if not active:
                break
            self.segments.run("coarse")
        self.sg.coarse_iterations.append(k)

    # ------------------------------------------------------------ segments

    def _down(self, r: list) -> None:
        sg = self.sg
        defect, sol = sg._down(r)
        for bufs, d in zip(self.defect, defect):
            _assign(bufs, d)
        for bufs, s in zip(self.sol, sol[1:]):
            _assign(bufs, s)
        full = dict(zip(sg.ctx.devices,
                        sg.ctx.all_gather(self.defect[0], "coarse")))
        for dev, c in self.coarse.items():
            c.start(full[dev])

    def _up(self) -> list:
        sol0 = self.sg._coarse_blocks({dev: c.x for dev, c in
                                       self.coarse.items()})
        return self.sg._up(list(self.defect), [sol0] + list(self.sol))

    def _test(self) -> None:
        self.active.copy_((self.res.double() > self.tol)
                          & (self.k < self.maxiter))
        self.info.copy_(torch.stack([self.active.double(), self.k.double(),
                                     self.res0.double(), self.res.double()]))

    def _start_head(self) -> None:
        r = [b - y for b, y in zip(self.rhs, self.sg._sys_mv(self.x))]
        res = self.sg._norm(r)
        _assign(self.r, r)
        self.res0.copy_(res)
        self.res.copy_(res)
        self._down(r)

    def _start_tail(self) -> None:
        z = self._up()
        _assign(self.p, z)
        _assign(self.rho, self.sg._pdot(self.r, z))
        self.k.zero_()
        self._test()

    def _step_head(self) -> None:
        sg = self.sg
        q = sg._sys_mv(self.p)
        alpha = [_safe_div(a, b) for a, b in zip(self.rho,
                                                 sg._pdot(self.p, q))]
        x = [xi + a * pi for xi, a, pi in zip(self.x, alpha, self.p)]
        r = [ri - a * qi for ri, a, qi in zip(self.r, alpha, q)]
        _assign(self.x, x)
        _assign(self.r, r)
        self.res.copy_(sg._norm(r))
        self._down(r)

    def _step_tail(self) -> None:
        z = self._up()
        rho = self.sg._pdot(self.r, z)
        p = [zi + _safe_div(a, b) * pi
             for zi, a, b, pi in zip(z, rho, self.rho, self.p)]
        _assign(self.p, p)
        _assign(self.rho, rho)
        self.k.add_(1)
        self._test()

    def _coarse_step(self) -> None:
        for c in self.coarse.values():
            c.step()


def _jacobi_cg(cols, vals, inv_diag, d, rtol: float, maxiter: int):
    """Jacobi-preconditioned CG for ``A x = d`` from zero to ``|r| <=
    rtol |d|`` or ``maxiter`` iterations (the JAX ``coarse_solve``).
    Returns (x, iterations)."""
    x = torch.zeros_like(d)
    r = d
    r2 = to_host(torch.dot(r, r))
    tol2 = rtol ** 2 * r2
    z = inv_diag * r
    p = z
    rho = torch.dot(r, z)
    k = 0
    while r2 > tol2 and k < maxiter:
        q = ell_mv(cols, vals, p)
        alpha = _safe_div(rho, torch.dot(p, q))
        x = x + alpha * p
        r = r - alpha * q
        z = inv_diag * r
        rho_new = torch.dot(r, z)
        p = z + _safe_div(rho_new, rho) * p
        rho = rho_new
        r2 = to_host(torch.dot(r, r))
        k += 1
    return x, k
