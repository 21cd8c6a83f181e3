"""Constraint-aware CSR assembly on the solve's device: the port's one
assembly engine.

The host-assembled routes (float64 golden parity, Step16, the level-matrix
GMG, the SPMD system) build their CSR system, level and interface
matrices from the plans made here, as torch code on the device that holds
the DoF numbering: the card in a run, the CPU in the tests.  The
semantics are deal.II's ``ConstraintMatrix::distribute_local_to_global``
(src/step-50.cc:735-833):

- unconstrained (i, j): ``K[I,J] += k_ij``;
- constrained rows and columns distributed with the resolved weights;
- ``K[I,I] += k_ii`` for each constrained local dof;
- the lift ``rhs -= K_cell g_local`` for inhomogeneous constraints;
- constrained rows with a zero rhs.

Two steps, split by topology:

* :func:`plan` (per mesh and constraint set) enumerates the matrix entries
  in the order of the JAX package's host plan (coulomb_gmg_tpu/fem/
  assembly.py: the clean cells' ``(cell, i, j)``, the dirty cells'
  constraint expansion, the constrained diagonals), sorts their
  int64 keys ``row * n + col`` stably and takes the unique keys: the CSR
  pattern, downloaded once, and for every CSR slot its run of entries in
  enumeration order.  The entries are processed in slabs of rows of at
  most about ``SLAB_ENTRIES`` entries, so that the sort's keys,
  permutation and scratch stay small; the plan kept between the steps is
  int32.
* :func:`assemble` sums each slot's run in that order: the hand kernel
  ``csrc/segment_sum.cu`` on the card (one thread a slot, no atomics, the
  bits of a sequential ``np.bincount``), its plain version on the CPU.
  The SPMD assembler (parallel/spmd.py:build_assembler) sums the same
  runs shard by shard instead.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.device import read_back, to_host, upload
from coulomb_gmg_tpu_torch.mesh.dofs import Constraints
from coulomb_gmg_tpu_torch.utils.timer import count

SLAB_ENTRIES = 1 << 19    # matrix entries sorted at once, about
_I32 = torch.int32
_I64 = torch.int64
_F64 = torch.float64
_SIGS = {"segment_sum_f64": [ctypes.c_void_p] * 4
         + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
         + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]}


@dataclass
class CSRPattern:
    n_rows: int
    indptr: np.ndarray
    indices: np.ndarray

    @property
    def nnz(self) -> int:
        return len(self.indices)


@dataclass
class CardConstraints:
    """Resolved constraints on a device: ``crow[dof]`` is the dof's row of
    the constraint CSR (``indptr``, ``cols``, ``weights``, ``inhomog``)
    or -1."""

    crow: torch.Tensor       # (n_dofs,) int64
    indptr: torch.Tensor     # (n_constrained + 1,) int64
    cols: torch.Tensor       # (nnz,) int64
    weights: torch.Tensor    # (nnz,) float64
    inhomog: torch.Tensor    # (n_constrained,) float64
    n_dofs: int


def card_constraints(con: Constraints, device) -> CardConstraints:
    """A host constraint set on ``device``."""
    rows = upload(np.asarray(con.rows, np.int64), device)
    crow = torch.full((con.n_dofs,), -1, dtype=_I64, device=device)
    crow[rows] = torch.arange(len(rows), device=device)
    return CardConstraints(
        crow=crow, indptr=upload(np.asarray(con.indptr, np.int64), device),
        cols=upload(np.asarray(con.cols, np.int64), device),
        weights=upload(np.asarray(con.weights, np.float64), device),
        inhomog=upload(np.asarray(con.inhomog, np.float64), device),
        n_dofs=con.n_dofs)


def eliminated(mask: torch.Tensor) -> CardConstraints:
    """The homogeneous elimination of the dofs where ``mask`` is set (the
    level matrices' ``level_constraints``; an all-false mask: none)."""
    dev = mask.device
    nr = int(mask.sum())
    crow = torch.where(mask, torch.cumsum(mask, 0) - 1,
                       torch.full_like(mask, -1, dtype=_I64))
    return CardConstraints(crow=crow,
                           indptr=torch.zeros(nr + 1, dtype=_I64, device=dev),
                           cols=torch.zeros(0, dtype=_I64, device=dev),
                           weights=torch.zeros(0, dtype=_F64, device=dev),
                           inhomog=torch.zeros(nr, dtype=_F64, device=dev),
                           n_dofs=len(mask))


@dataclass
class CellMatrices:
    """The cells' element matrices, float64 on the device: ``scale[c] *
    kvals[i * nb + j]`` (unit coefficient, float64: the reference
    stiffness times ``h^(dim-2)``, never materialised) or ``kvals[(c * nb
    + i) * nb + j]`` (``scale`` None)."""

    kvals: torch.Tensor
    scale: Optional[torch.Tensor]
    nb: int

    def take(self, cells: torch.Tensor) -> "CellMatrices":
        if self.scale is not None:
            return CellMatrices(self.kvals, self.scale[cells], self.nb)
        k = self.kvals.view(-1, self.nb * self.nb)[cells]
        return CellMatrices(k.reshape(-1), None, self.nb)

    def cells(self, cells: torch.Tensor) -> torch.Tensor:
        """(len(cells), nb, nb) element matrices of ``cells``."""
        nb = self.nb
        if self.scale is None:
            return self.kvals.view(-1, nb, nb)[cells]
        return self.scale[cells][:, None, None] * self.kvals.view(nb, nb)


def cell_matrices(tables, h: torch.Tensor, coeff_q=None,
                  dtype=torch.float64) -> CellMatrices:
    """The stiffness of fem/integrals.py:stiffness_cells_np in ``dtype``,
    each value with its bits, as float64 on ``h``'s device.  Unit
    coefficient: the reference stiffness as numpy computes it, times
    ``h^(dim-2)`` on the device (kept in the scaled form in float64);
    ``coeff_q`` (numpy, the coefficient at the quadrature points): the
    element matrices computed on the host and uploaded."""
    from coulomb_gmg_tpu_torch.fem.integrals import stiffness_cells_np
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    nb = tables.grad_outer.shape[1]
    if coeff_q is not None:
        k = stiffness_cells_np(tables, to_host(h), coeff_q, dtype=np_dtype)
        return CellMatrices(upload(k.reshape(-1), h.device).to(_F64), None,
                            nb)
    w = np.asarray(tables.weights, np_dtype)
    G = np.asarray(tables.grad_outer, np_dtype)
    k_ref = upload(np.einsum("q,qij->ij", w, G).reshape(-1), h.device)
    scale = h.to(dtype) ** (tables.dim - 2)
    if dtype == torch.float64:
        return CellMatrices(k_ref, scale, nb)
    return CellMatrices((scale[:, None] * k_ref).reshape(-1).to(_F64), None,
                        nb)


@dataclass
class Expansion:
    """The dirty cells' constraint expansion on the device: each local dof
    of each dirty cell in order, unconstrained, as itself with weight 1,
    constrained, as its resolved columns and weights.  Entry ``a`` belongs
    to the dirty cell ``cell[a]`` (global cell ``dirty_idx[cell[a]]``) and
    its local dof ``i[a]``; the cell's entries are ``cell_off[c]`` to
    ``cell_off[c + 1]``.  The matrix entry of the pair ``(a, b)`` of one
    cell is coded ``-1 - (a * kq + b - cell_off[cell[a]])``: ``k[c, i[a],
    i[b]] * (w[a] * w[b])``."""

    dof: torch.Tensor        # (E,) int64
    cell: torch.Tensor       # (E,) int32, the dirty-local cell
    i: torch.Tensor          # (E,) int32
    w: torch.Tensor          # (E,) float64
    cell_off: torch.Tensor   # (nd + 1,) int32
    dirty_idx: torch.Tensor  # (nd,) int32
    g_local: torch.Tensor    # (nd, nb) float64: the inhomogeneities
    kq: int                  # at least the longest cell expansion


@dataclass
class CardPlan:
    """The pattern of one matrix and the run of entries of each slot.

    ``pattern`` is the CSR's pattern on the host; the rest lives on the
    device until :meth:`release`.  ``src`` codes an entry: ``t >= 0`` the
    element entry ``(c * nb + i) * nb + j`` with weight 1, ``t < 0`` a pair
    of the dirty cells' expansion (:class:`Expansion`)."""

    pattern: CSRPattern
    n_cells: int
    nb: int
    seg: Optional[torch.Tensor]          # (nnz + 1,) int32
    src: Optional[torch.Tensor]          # (entries,) int32
    ex: Optional[Expansion]
    rhs_seg: Optional[torch.Tensor] = None   # (n + 1,) int32
    rhs_src: Optional[torch.Tensor] = None   # clean (c * nb + i), else -1 - a

    def release(self) -> None:
        """Free the device arrays; the host pattern stays."""
        self.seg = self.src = self.ex = self.rhs_seg = self.rhs_src = None


def _excl(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums with the total appended (int64)."""
    out = torch.zeros(len(counts) + 1, dtype=_I64, device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def _ragged(counts: torch.Tensor, total: int):
    """(owner, inner) of ``total = counts.sum()`` items: the segment of
    each item and its position in the segment."""
    dev = counts.device
    owner = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                    counts, output_size=total)
    inner = torch.arange(total, device=dev) - _excl(counts)[:-1][owner]
    return owner, inner


def _expand(c2d: torch.Tensor, crow: torch.Tensor, dirty_idx: torch.Tensor,
            con: CardConstraints) -> Expansion:
    """The :class:`Expansion` of the dirty cells ``c2d`` (``crow``: their
    local dofs' constraint rows)."""
    nd, nb = c2d.shape
    dev = c2d.device
    flat_dof, flat_crow = c2d.reshape(-1), crow.reshape(-1)
    con_ = flat_crow >= 0
    cnt = torch.ones(nd * nb, dtype=_I64, device=dev)
    cnt[con_] = torch.diff(con.indptr)[flat_crow[con_]]
    owner, inner = _ragged(cnt, int(cnt.sum()))
    dof = flat_dof[owner]
    w = torch.ones(len(owner), dtype=_F64, device=dev)
    sel = torch.nonzero(con_[owner]).squeeze(1)
    at = con.indptr[flat_crow[owner[sel]]] + inner[sel]
    dof[sel] = con.cols[at]
    w[sel] = con.weights[at]
    cell_cnt = cnt.view(nd, nb).sum(1)
    d_sel = torch.nonzero(con_).squeeze(1)
    g_local = torch.zeros(nd * nb, dtype=_F64, device=dev)
    g_local[d_sel] = con.inhomog[flat_crow[d_sel]]
    kq = int(cell_cnt.max()) if nd else 1
    if len(dof) * kq >= 2 ** 31:
        raise ValueError("card assembly: the constraint expansion exceeds "
                         "int32 codes")
    return Expansion(dof=dof, cell=(owner // nb).to(_I32),
                     i=(owner % nb).to(_I32), w=w,
                     cell_off=_excl(cell_cnt).to(_I32),
                     dirty_idx=dirty_idx.to(_I32),
                     g_local=g_local.view(nd, nb), kq=kq)


def plan(cell2dof: torch.Tensor, con: CardConstraints, rhs: bool = False,
         keep=None) -> CardPlan:
    """The plan of the matrix of ``cell2dof`` (on its device) under
    ``con``; with ``rhs`` also the load vector's runs.  ``keep(rows,
    cols)``: the slots whose sums are kept, the others summing nothing
    (0.0) but staying in the pattern."""
    dev = cell2dof.device
    c2d = cell2dof.to(_I64)
    nb = c2d.shape[1]
    nb2, n = nb * nb, con.n_dofs
    crow = con.crow[c2d]
    dirty = (crow >= 0).any(1)
    clean_idx = torch.nonzero(~dirty).squeeze(1)
    dirty_idx = torch.nonzero(dirty).squeeze(1)
    dc2d, dcrow = c2d[dirty_idx], crow[dirty_idx]
    ex = _expand(dc2d, dcrow, dirty_idx, con)
    # the constrained diagonals: each constrained local dof of a dirty cell
    d_flat = torch.nonzero(dcrow.view(-1) >= 0).squeeze(1)
    d_dof = dc2d.view(-1)[d_flat]
    d_src = (dirty_idx[d_flat // nb] * nb2 + d_flat % nb * (nb + 1)).to(_I32)
    cc = c2d[clean_idx].to(_I32)               # (nc, nb)
    rows_ci = cc.view(-1)                      # the row of each clean (c, i)
    del c2d, crow, dirty, dc2d, dcrow, d_flat
    cnt = torch.diff(ex.cell_off.to(_I64))
    a_cnt = cnt[ex.cell.to(_I64)]              # pairs of each expansion entry

    # entries per row, so that the slabs split no row
    row_cnt = torch.zeros(n, dtype=_I64, device=dev)
    row_cnt.index_add_(0, rows_ci.to(_I64),
                       torch.full((len(rows_ci),), nb, dtype=_I64,
                                  device=dev))
    row_cnt.index_add_(0, ex.dof, a_cnt)
    row_cnt.index_add_(0, d_dof, torch.ones_like(d_dof))
    first = _excl(row_cnt)
    del row_cnt
    n_entries = int(first[-1])
    if n_entries >= 2 ** 31:
        raise ValueError(f"card assembly: {n_entries} entries exceed int32")
    marks = torch.arange(1, -(-n_entries // SLAB_ENTRIES), device=dev,
                         dtype=_I64) * SLAB_ENTRIES
    cuts = torch.searchsorted(first[:-1], marks).tolist()
    bounds = sorted(set([0] + cuts + [n]))
    del first

    src = torch.empty(n_entries, dtype=_I32, device=dev)
    row_nnz = torch.zeros(n, dtype=_I64, device=dev)
    seg, indices = [], []
    at = 0                                     # entries kept so far
    ar_nb = torch.arange(nb, device=dev, dtype=_I32)
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        keys, srcs = [], []
        # clean cells: (cell, i) with its row here, every j
        p = torch.nonzero((rows_ci >= r0) & (rows_ci < r1)).squeeze(1)
        k = p // nb
        keys.append(((rows_ci[p].to(_I64) - r0)[:, None] * n
                     + cc[k]).view(-1))
        srcs.append(((clean_idx[k] * nb + p % nb) * nb).to(_I32)[:, None]
                    + ar_nb)
        # dirty cells: expansion a with its row here, against every b of
        # its cell
        a = torch.nonzero((ex.dof >= r0) & (ex.dof < r1)).squeeze(1)
        ka = a_cnt[a]
        own, j = _ragged(ka, int(ka.sum()))
        a = a[own]
        b = ex.cell_off[ex.cell[a].to(_I64)].to(_I64) + j
        keys.append((ex.dof[a] - r0) * n + ex.dof[b])
        srcs.append((-1 - (a * ex.kq + j)).to(_I32))
        # constrained diagonals
        q = torch.nonzero((d_dof >= r0) & (d_dof < r1)).squeeze(1)
        keys.append((d_dof[q] - r0) * n + d_dof[q])
        srcs.append(d_src[q])
        skey, perm = torch.sort(torch.cat(keys), stable=True)
        del keys
        run = torch.cat([s.view(-1) for s in srcs])[perm]
        del srcs, perm
        uniq, counts = torch.unique_consecutive(skey, return_counts=True)
        del skey
        rows, cols = uniq // n + r0, uniq % n
        if keep is not None:
            kept = keep(rows, cols)
            run = run[torch.repeat_interleave(kept, counts,
                                              output_size=len(run))]
            counts = torch.where(kept, counts, torch.zeros_like(counts))
        src[at: at + len(run)] = run
        seg.append((at + _excl(counts)[:-1]).to(_I32))
        at += len(run)
        row_nnz[r0:r1] += torch.bincount(rows - r0, minlength=r1 - r0)
        indices.append(read_back(cols.to(_I32)))
        del run, uniq, counts, rows, cols
    seg.append(torch.tensor([at], dtype=_I32, device=dev))
    count("assembly_entries", n_entries)
    p = CardPlan(pattern=CSRPattern(
                     n_rows=n, indptr=read_back(_excl(row_nnz)),
                     indices=np.concatenate(indices).astype(np.int64)),
                 n_cells=len(cell2dof), nb=nb, seg=torch.cat(seg),
                 src=src[:at], ex=ex)
    if rhs:
        # the load vector: clean (cell, i) to its dof, then every
        # expansion entry, stably sorted by dof
        tgt = torch.cat([rows_ci, ex.dof.to(_I32)])
        _, perm = torch.sort(tgt, stable=True)
        rsrc = torch.cat([((clean_idx * nb).to(_I32)[:, None]
                           + ar_nb).view(-1),
                          (-1 - torch.arange(len(ex.dof), device=dev)
                           ).to(_I32)])
        p.rhs_src = rsrc[perm]
        del rsrc, perm
        p.rhs_seg = _excl(torch.bincount(tgt, minlength=n)).to(_I32)
    return p


def assemble(p: CardPlan, k: CellMatrices, f_cells=None,
             dtype=torch.float64):
    """(data (nnz,), rhs (n,) or None) in ``dtype`` on the plan's device:
    each CSR slot's run summed in enumeration order, in float64.
    ``f_cells``: the (n_cells, nb) load vectors, with a plan made with
    ``rhs``."""
    count("assembly_card_calls")
    if p.nb != k.nb:
        raise ValueError(f"card assembly: plan of {p.nb} local dofs, "
                         f"element matrices of {k.nb}")
    data = segment_sum(p.seg, p.src, k.kvals, k.scale, p.nb, ex=p.ex)
    data = data.to(dtype)
    if f_cells is None:
        return data, None
    ex = p.ex
    f = f_cells.to(_F64)
    dirty = ex.dirty_idx.to(_I64)
    lift = (k.cells(dirty) * ex.g_local[:, None, :]).sum(-1)
    f_eff = (f[dirty] - lift).reshape(-1)
    rvals = f_eff[ex.cell.to(_I64) * p.nb + ex.i] * ex.w
    rhs = segment_sum(p.rhs_seg, p.rhs_src, f.reshape(-1), None, 1,
                      dvals=rvals)
    return data, rhs.to(dtype)


def segment_sum(seg: torch.Tensor, src: torch.Tensor, kvals: torch.Tensor,
                scale: Optional[torch.Tensor], nb: int,
                ex: Optional[Expansion] = None,
                dvals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum of v(src[e]) for e in [seg[s], seg[s + 1])`` in
    order, from 0.0, in float64.  With ``k(t) = scale[t // nb^2] *
    kvals[t % nb^2]`` (``kvals[t]`` without ``scale``): ``v(t) = k(t)``
    for ``t >= 0``; for ``t < 0``, ``q = -1 - t``, ``v = dvals[q]``, or
    the expansion's pair ``q`` (:class:`Expansion`).  The hand kernel on
    the card, the plain version on the CPU; both give the bits of a
    sequential sum."""
    if not seg.is_cuda:
        return segment_sum_plain(seg, src, kvals, scale, nb, ex, dvals)
    ops = [seg, src, kvals] + [t for t in (scale, dvals) if t is not None]
    if ex is not None:
        ops += [ex.cell, ex.i, ex.w, ex.cell_off, ex.dirty_idx]
    if not all(t.is_cuda and t.device == seg.device and t.is_contiguous()
               for t in ops):
        raise ValueError("segment_sum: operands must be contiguous on one "
                         "card")
    if any(t.dtype != _F64 for t in [kvals, scale, dvals]
           + ([ex.w] if ex is not None else []) if t is not None) or any(
            t.dtype != _I32 for t in [seg, src] + (
                [ex.cell, ex.i, ex.cell_off, ex.dirty_idx]
                if ex is not None else [])):
        raise TypeError("segment_sum: int32 indices, float64 values")
    ptr = lambda t: None if t is None else t.data_ptr()
    n_slots = len(seg) - 1
    out = torch.empty(n_slots, dtype=_F64, device=seg.device)
    lib = kernels.library("segment_sum", _SIGS)
    kernels.launch(lib.segment_sum_f64, seg.device, "segment_sum",
                   seg.data_ptr(), src.data_ptr(), kvals.data_ptr(),
                   ptr(scale), nb, ptr(dvals),
                   ex.kq if ex is not None else 1,
                   ptr(ex and ex.cell), ptr(ex and ex.i), ptr(ex and ex.w),
                   ptr(ex and ex.cell_off), ptr(ex and ex.dirty_idx),
                   out.data_ptr(), n_slots)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_plain(seg, src, kvals, scale, nb, ex=None,
                      dvals=None) -> torch.Tensor:
    """The kernel's arithmetic in torch: each entry's value, then the k-th
    entry of every run that has one added in turn to the run's sum."""
    nb2 = nb * nb
    kval = ((lambda t: kvals[t]) if scale is None
            else (lambda t: scale[t // nb2] * kvals[t % nb2]))
    seg = seg.to(_I64)
    t = src.to(_I64)
    v = kval(t.clamp(min=0))
    neg = torch.nonzero(t < 0).squeeze(1)
    q = -1 - t[neg]
    if dvals is not None:
        v[neg] = dvals[q]
    elif len(neg):
        a, j = q // ex.kq, q % ex.kq
        c = ex.cell[a].to(_I64)
        b = ex.cell_off[c].to(_I64) + j
        flat = (ex.dirty_idx[c].to(_I64) * nb + ex.i[a]) * nb + ex.i[b]
        v[neg] = kval(flat) * (ex.w[a] * ex.w[b])
    out = torch.zeros(len(seg) - 1, dtype=_F64, device=seg.device)
    live = torch.nonzero(torch.diff(seg) > 0).squeeze(1)
    k = 0
    while len(live):
        out[live] += v[seg[live] + k]
        k += 1
        live = live[seg[live + 1] - seg[live] > k]
    return out
