"""Sharded linear algebra over the shards of an SpmdContext.

Counterpart of coulomb_gmg_tpu/parallel/sharded.py, the reference's MPI
domain decomposition with row-partitioned Trilinos matrices, ghost imports
and scalar all-reduces inside CG (src/step-50.cc:653-657, 831-832):

* DoFs are row-partitioned into contiguous equal blocks (padded): shard d
  owns rows ``[d * block, (d + 1) * block)`` and holds them on its own
  device;
* an operator is, per shard, an ELL over the shard's extended vector
  ``[own block | ghosts]`` (:class:`HaloPlan`), applied by the ELL kernel
  (ops/ell.py).  Every row keeps the term order of the global CSR row, so
  a sharded product has the bits of the single-device one.  The JAX
  module's COO scatter-add (``_local_matvec``) is not carried over: on
  CUDA a scatter-add is atomic and its order of additions varies;
* the ghost import is an ``index_select`` from the owning shard's tensor
  (:func:`halo_import`); with ``halo=False`` every shard gathers the whole
  vector instead (the JAX module's all_gather oracle);
* dot products are per-shard partials summed in shard order
  (``SpmdContext.psum``);
* across processes (an ``SpmdContext`` with a process group) each rank
  holds only its own shards, as each JAX process materializes only its
  addressable shards: the host plans are built on every rank from the
  global column lists, every per-shard list holds the local shards, and
  the ghosts that another rank owns arrive in one ``all_to_all_single``
  per import (``SpmdContext.exchange``), each at the place the
  one-process plan gives it.

:func:`make_sharded_solver` is the sharded Jacobi-CG in two forms: the
eager host loop, and (``fused``, the default) the stepped solve of
solver/fused.py:SteppedCG, CUDA graphs when every local shard is on one
card of one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import SlicedELL, ell_mv
from coulomb_gmg_tpu_torch.solver.cg import to_host
from coulomb_gmg_tpu_torch.solver.fused import SteppedCG


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def put_blocks(a, ctx, dtype: Optional[torch.dtype] = None) -> list:
    """(D, ...) host array -> one tensor per local shard, on the shard's
    device."""
    a = np.asarray(a)
    out = []
    for d, dev in zip(ctx.shards, ctx.devices):
        t = torch.from_numpy(np.ascontiguousarray(a[d])).to(dev)
        out.append(t if dtype is None else t.to(dtype))
    return out


@dataclass
class ShardedCSR:
    """Row-partitioned sparse matrix as per-shard COO blocks, in the row
    order of the global matrix.

      rows_local[d]: row index within shard d's block
      cols[d]:       GLOBAL column index
      data[d]:       entry values
    """

    n_rows: int            # global (padded) row count
    block: int             # rows per shard
    rows_local: List[np.ndarray]
    cols: List[np.ndarray]
    data: List[np.ndarray]

    @staticmethod
    def from_coo(rowids, cols, data, n_rows: int, n_dev: int) -> "ShardedCSR":
        n_pad = round_up(n_rows, n_dev)
        block = n_pad // n_dev
        r, c, v = block_coo(rowids, cols, data, block, n_dev)
        return ShardedCSR(n_rows=n_pad, block=block, rows_local=r, cols=c,
                          data=v)


def block_coo(rowids, cols, data, block: int, n_dev: int):
    """Partition COO entries by owner row into per-shard (local row ids,
    global col ids, values), keeping their order."""
    rowids = np.asarray(rowids, np.int64)
    cols = np.asarray(cols, np.int64)
    data = np.asarray(data)
    owner = rowids // block
    r, c, v = [], [], []
    for d in range(n_dev):
        sel = owner == d
        r.append(rowids[sel] - d * block)
        c.append(cols[sel])
        v.append(data[sel])
    return r, c, v


def shard_vector(x: np.ndarray, n_dev: int) -> np.ndarray:
    n_pad = round_up(len(x), n_dev)
    out = np.zeros(n_pad, dtype=np.asarray(x).dtype)
    out[: len(x)] = np.asarray(x)
    return out.reshape(n_dev, -1)


@dataclass
class HaloPlan:
    """Ghost-import plan of the operators that read one row-partitioned
    source vector (the locally-owned / locally-relevant IndexSets of
    src/step-50.cc:653-657, 722-731).

    need[d][s]: sorted GLOBAL ids that shard d reads from shard s;
    cols_local[d]: the operators' column ids in shard d's extended
    numbering ``[own block | ghosts in ascending global id]``.
    ``gather``: every shard reads the whole vector instead (columns stay
    global)."""

    block: int
    need: List[List[np.ndarray]]
    cols_local: List[np.ndarray]
    gather: bool = False
    _routes: "_Routes" = None

    @staticmethod
    def build(cols: List[np.ndarray], block: int, n_dev: int,
              halo: bool = True) -> "HaloPlan":
        """cols[d]: the GLOBAL column ids of shard d's entries."""
        D = n_dev
        cols = [np.asarray(c, np.int64) for c in cols]
        if not halo:
            return HaloPlan(block=block, need=[[] for _ in range(D)],
                            cols_local=cols, gather=True)
        need, cols_local = [], []
        for d in range(D):
            c = cols[d]
            lo = d * block
            g = np.unique(c)
            ghosts = g[(g < lo) | (g >= lo + block)]
            owners = np.minimum(ghosts // block, D - 1)
            need.append([ghosts[owners == s] for s in range(D)])
            inside = (c >= lo) & (c < lo + block)
            cols_local.append(np.where(inside, c - lo,
                                       block + np.searchsorted(ghosts, c)))
        return HaloPlan(block=block, need=need, cols_local=cols_local)

    def routes(self, ctx) -> "_Routes":
        """The index sets of this rank's imports under ``ctx`` (built
        once)."""
        if self._routes is None:
            self._routes = _Routes.build(self, ctx)
        return self._routes


@dataclass
class _Routes:
    """One rank's part of a :class:`HaloPlan`, fixed once.

    local[(s, d)]: indices into local shard s's block that local shard d
    reads, on s's device; send[q]: the (s, indices) pieces of the message
    to rank q, in (d, s) order; recv[r]: the (d, s, size) pieces of the
    message from rank r, in the same order; ``cross``: whether any rank
    imports from another (the same answer on every rank)."""

    local: dict
    send: list
    recv: list
    cross: bool

    @staticmethod
    def build(plan: "HaloPlan", ctx) -> "_Routes":
        D, W, per = ctx.D, ctx.W, ctx.D // ctx.W
        dev = dict(zip(ctx.shards, ctx.devices))
        rank_of = lambda d: d // per
        ids = lambda s, d: torch.from_numpy(
            plan.need[d][s] - s * plan.block).to(dev[s])
        local, send = {}, [[] for _ in range(W)]
        recv = [[] for _ in range(W)]
        cross = False
        for d in range(D):
            for s in range(D):
                n = len(plan.need[d][s])
                if not n:
                    continue
                if rank_of(s) != rank_of(d):
                    cross = True
                if s in dev and d in dev:
                    local[(s, d)] = ids(s, d)
                elif s in dev:
                    send[rank_of(d)].append((s, ids(s, d)))
                elif d in dev:
                    recv[rank_of(s)].append((d, s, n))
        return _Routes(local=local, send=send, recv=recv, cross=cross)


def halo_import(xs: list, plan: HaloPlan, ctx) -> list:
    """Per-shard local blocks -> per-shard extended vectors
    ``[own | ghosts]``: each ghost is an ``index_select`` from the owning
    shard's tensor, received from its rank when another rank owns it (the
    whole vector when ``plan.gather``)."""
    if plan.gather:
        return ctx.all_gather(xs)
    rt = plan.routes(ctx)
    x_of = dict(zip(ctx.shards, xs))
    ghosts = {}
    if rt.cross:
        msgs = [torch.cat([x_of[s].index_select(0, i).to(ctx.devices[0])
                           for s, i in pieces]) if pieces else xs[0][:0]
                for pieces in rt.send]
        got = ctx.exchange(msgs, [sum(n for _, _, n in p) for p in rt.recv])
        for buf, pieces in zip(got, rt.recv):
            for (d, s, _), g in zip(pieces, buf.split(
                    [n for _, _, n in pieces])):
                ghosts[(s, d)] = g
    out = []
    for d, x in zip(ctx.shards, xs):
        parts = [x]
        for s in range(ctx.D):
            if (s, d) in rt.local:
                parts.append(x_of[s].index_select(0, rt.local[(s, d)]).to(
                    x.device))
            elif (s, d) in ghosts:
                parts.append(ghosts[(s, d)].to(x.device))
        out.append(torch.cat(parts) if len(parts) > 1 else x)
    return out


def shard_ells(rows_local, cols_local, data, block: int, ctx,
               dtype: torch.dtype) -> list:
    """Per-local-shard sliced ELL pairs of ``block`` rows
    (ops/ell.py:SlicedELL) on the shards' devices, from the lists of all D
    shards."""
    return [SlicedELL.from_coo(rows_local[d], cols_local[d], data[d],
                               block).device(dev, dtype)
            for d, dev in zip(ctx.shards, ctx.devices)]


def apply_ells(ells: list, ext: list) -> list:
    """Per-shard ``y_d = A_d ext_d`` by the ELL kernel."""
    return [ell_mv(c, v, e) for (c, v), e in zip(ells, ext)]


def make_sharded_solver(ctx, A: ShardedCSR, diag_block,
                        tol_rtol: float = 1e-8, maxiter: int = 500,
                        damping: float = 0.6, halo: bool = True,
                        fused: bool = True):
    """Sharded Jacobi-preconditioned CG (the reference's Jacobi solve
    path, src/step-50.cc:996-1005), iterating while ``|r| >= tol`` and
    ``k < maxiter``, ``tol = tol_rtol |rhs|``.  JAX runs it as one
    while loop in one executable.  ``fused`` (the driver's
    ``solve_fused``): the stepped solve of solver/fused.py:SteppedCG, its
    state on the device, one host read per iteration (and one of
    ``|rhs|`` for the tolerance, as the eager loop), its two segments
    CUDA graphs when every local shard is on one card of one process
    (``SpmdContext.graph_mode``), captured for each call and released
    after it; else the eager host loop, which reads the norms as it goes.
    Both give the same bits.

    Returns fn(rhs_blocks, x0_blocks) -> (x_blocks, iters, |r0|, |r|);
    blocks are lists of per-shard (block,) tensors (:func:`put_blocks`).
    ``fn.info`` holds the last call's ``mode`` and host ``reads``."""
    D = ctx.D
    plan = HaloPlan.build(A.cols, A.block, D, halo)
    dtype = torch.float64 if np.asarray(A.data[0]).dtype == np.float64 \
        else torch.float32
    ells = shard_ells(A.rows_local, plan.cols_local, A.data, A.block, ctx,
                      dtype)
    inv_diag = put_blocks(damping / np.asarray(diag_block), ctx, dtype)
    if not plan.gather:
        plan.routes(ctx)

    def matvec(xs):
        return apply_ells(ells, halo_import(xs, plan, ctx))

    def precond(rs):
        return [m * v for m, v in zip(inv_diag, rs)]

    def dot(a, b):
        return ctx.psum([torch.dot(x, y) for x, y in zip(a, b)])

    def norm(a):
        return torch.sqrt(dot(a, a)[0])

    def eager(rhs_b, x0_b):
        x = list(x0_b)
        r = [b - y for b, y in zip(rhs_b, matvec(x))]
        res0 = to_host(norm(r))
        tol = tol_rtol * to_host(norm(rhs_b))
        z = precond(r)
        p = z
        rho = dot(r, z)
        res, k = res0, 0
        while res >= tol and k < maxiter:
            q = matvec(p)
            alpha = [a / b for a, b in zip(rho, dot(p, q))]
            x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
            r = [ri - a * qi for ri, a, qi in zip(r, alpha, q)]
            res = to_host(norm(r))
            z = precond(r)
            rho_new = dot(r, z)
            p = [zi + (a / b) * pi for zi, a, b, pi in zip(z, rho_new, rho,
                                                            p)]
            rho = rho_new
            k += 1
        return x, k, res0, res

    def run(rhs_b, x0_b):
        reads = to_host.reads
        if not fused:
            out = eager(rhs_b, x0_b)
            run.info = {"mode": "eager: host loop"}
        else:
            capture, mode = ctx.graph_mode()
            st = SteppedCG(matvec, precond, dot, norm, list(rhs_b),
                           capture=capture)
            try:
                out = tuple(st.solve(rhs_b, x0_b,
                                     tol_rtol * to_host(norm(rhs_b)),
                                     maxiter))
            finally:
                st.release()
            seg = st.segments
            run.info = {"mode": mode, "capture_s": seg.capture_s,
                        "instantiate_s": seg.instantiate_s,
                        "warmup": dict(seg.warmup)}
        run.info["reads"] = to_host.reads - reads
        return out

    run.info = {}
    return run


def sharded_diag(A: ShardedCSR, n_dev: int) -> np.ndarray:
    """(D, block) diagonal of the sharded matrix; rows without a diagonal
    entry (padding rows) get 1 so Jacobi stays well-defined."""
    out = np.zeros((n_dev, A.block), dtype=np.asarray(A.data[0]).dtype)
    for dev in range(n_dev):
        grow = A.rows_local[dev] + dev * A.block
        mask = A.cols[dev] == grow
        out[dev, A.rows_local[dev][mask]] = A.data[dev][mask]
    out[out == 0.0] = 1.0
    return out
