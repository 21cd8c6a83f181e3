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
  (``SpmdContext.psum``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.ell import ELL, ell_mv


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def put_blocks(a, ctx, dtype: Optional[torch.dtype] = None) -> list:
    """(D, ...) host array -> one tensor per shard, on the shard's device."""
    a = np.asarray(a)
    out = []
    for d, dev in enumerate(ctx.devices):
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
    _send: dict = None

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

    def send(self, ctx) -> dict:
        """(s, d) -> the local indices into shard s's block that shard d
        reads, on shard s's device (built once)."""
        if self._send is None:
            self._send = {
                (s, d): torch.from_numpy(ids - s * self.block).to(
                    ctx.devices[s])
                for d, per in enumerate(self.need)
                for s, ids in enumerate(per) if len(ids)}
        return self._send


def halo_import(xs: list, plan: HaloPlan, ctx) -> list:
    """Per-shard local blocks -> per-shard extended vectors
    ``[own | ghosts]``: each ghost is an ``index_select`` from the owning
    shard's tensor (the whole vector when ``plan.gather``)."""
    if plan.gather:
        return ctx.all_gather(xs)
    send = plan.send(ctx)
    out = []
    for d, x in enumerate(xs):
        parts = [x] + [xs[s].index_select(0, send[(s, d)]).to(x.device)
                       for s in range(ctx.D) if (s, d) in send]
        out.append(torch.cat(parts) if len(parts) > 1 else x)
    return out


def shard_ells(rows_local, cols_local, data, block: int, ctx,
               dtype: torch.dtype) -> list:
    """Per-shard transposed (K, block) ELL pairs on the shards' devices."""
    return [ELL.from_coo(r, c, v, block).device(dev, dtype)
            for r, c, v, dev in zip(rows_local, cols_local, data,
                                    ctx.devices)]


def apply_ells(ells: list, ext: list) -> list:
    """Per-shard ``y_d = A_d ext_d`` by the ELL kernel."""
    return [ell_mv(c, v, e) for (c, v), e in zip(ells, ext)]


def make_sharded_solver(ctx, A: ShardedCSR, diag_block,
                        tol_rtol: float = 1e-8, maxiter: int = 500,
                        damping: float = 0.6, halo: bool = True):
    """Sharded Jacobi-preconditioned CG (the reference's Jacobi solve
    path, src/step-50.cc:996-1005).

    Returns fn(rhs_blocks, x0_blocks) -> (x_blocks, iters, |r0|, |r|);
    blocks are lists of per-shard (block,) tensors (:func:`put_blocks`)."""
    D = ctx.D
    plan = HaloPlan.build(A.cols, A.block, D, halo)
    dtype = torch.float64 if np.asarray(A.data[0]).dtype == np.float64 \
        else torch.float32
    ells = shard_ells(A.rows_local, plan.cols_local, A.data, A.block, ctx,
                      dtype)
    inv_diag = put_blocks(damping / np.asarray(diag_block), ctx, dtype)

    def matvec(xs):
        return apply_ells(ells, halo_import(xs, plan, ctx))

    def dot(a, b):
        return ctx.psum([torch.dot(x, y) for x, y in zip(a, b)])

    def norm(a):
        return float(torch.sqrt(dot(a, a)[0]))

    def run(rhs_b, x0_b):
        x = list(x0_b)
        r = [b - y for b, y in zip(rhs_b, matvec(x))]
        res0 = norm(r)
        tol = tol_rtol * norm(rhs_b)
        z = [m * v for m, v in zip(inv_diag, r)]
        p = z
        rho = dot(r, z)
        res, k = res0, 0
        while res >= tol and k < maxiter:
            q = matvec(p)
            alpha = [a / b for a, b in zip(rho, dot(p, q))]
            x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
            r = [ri - a * qi for ri, a, qi in zip(r, alpha, q)]
            res = norm(r)
            z = [m * v for m, v in zip(inv_diag, r)]
            rho_new = dot(r, z)
            p = [zi + (a / b) * pi for zi, a, b, pi in zip(z, rho_new, rho,
                                                            p)]
            rho = rho_new
            k += 1
        return x, k, res0, res

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
