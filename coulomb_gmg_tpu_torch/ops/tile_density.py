"""Locality-cut charge density at the RHS quadrature points.

Counterpart of coulomb_gmg_tpu/ops/tile_density.py.  The host plan is the
same: atoms sorted by spatial bucket (ops/neighbors.py), cells grouped into
blocks of ``cpb`` cells in forest (SFC) order, and for each block the atom
tiles that can hold atoms within the cutoff of its cells' level-0 ancestor
boxes.  The TPU plan's packed 12-bit work list, its SMEM chunking and its
bucket padding exist only for the TPU's scalar memory and compiler; here the
work list is a CSR: ``blk_ptr[b] .. blk_ptr[b + 1]`` indexes the atom tiles
``atile`` of block ``b``.  Tiles hold ``A_TILE`` = 64 atoms, not the TPU's
512, so that few atoms outside every cell's cutoff are staged: the kernel
tests membership once per (cell, atom) of a tile and works only on members.

:func:`tile_density` evaluates the density on it: the hand kernel in
``csrc/tile_density.cu`` on the card, :func:`tile_density_plain` for CPU
tensors.  Membership is the production semantics (atom within ``cutoff`` of
any vertex of the cell's level-0 ancestor, strict ``<``), exact in float32
for lattice data (see the JAX module's docstring).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.ops.neighbors import build_atom_buckets
from coulomb_gmg_tpu_torch.utils.timer import span
from coulomb_gmg_tpu_torch import kernels

P_TILE = 512              # points per cell block (cpb = P_TILE // n_q cells)
A_TILE = 64               # atoms per tile; the kernel takes only this width
PAD_CELL = 1 << 20        # integer coordinate that puts a pad cell far away
PAD_ATOM = 1.0e6          # coordinate of pad atoms (charge 0)


@dataclass
class TilePlan:
    """Host-side work plan for one (forest topology, atom set)."""

    cpb: int                 # cells per block
    n_q: int
    a_tile: int
    nb: int                  # blocks; nb * cpb covers every output row
    blk_ptr: np.ndarray      # (nb + 1,) int32 CSR offsets into atile
    atile: np.ndarray        # (n_items,) int32 atom-tile id, block-major
    cells: np.ndarray        # (nb * cpb, dim + 1) int32: ijk + level
    atoms: np.ndarray        # (4, A_pad) float32: sorted x, y, z, charge


def build_tile_plan(forest: Forest, n_q: int, positions: np.ndarray,
                    charges: np.ndarray, cutoff: float, a_tile: int = A_TILE,
                    n_rows: Optional[int] = None) -> TilePlan:
    """The work plan of coulomb_gmg_tpu/ops/tile_density.py:build_tile_plan
    as a CSR over cell blocks.  ``n_rows`` (>= n_cells) is the number of
    output rows the blocks must cover."""
    dim = forest.dim
    C = forest.n_cells
    positions = np.asarray(positions, np.float64)
    A = len(positions)
    cpb = max(P_TILE // n_q, 1)
    n_rows = C if n_rows is None else max(int(n_rows), C)
    nb = max((n_rows + cpb - 1) // cpb, 1)

    # ---- sorted atoms (the bucket hash of ops/neighbors.py)
    pitch = max(cutoff, 1e-12)
    origin = positions.min(axis=0)
    order, starts, shape, lo = build_atom_buckets(positions, pitch, origin)
    borigin = origin + lo * pitch
    A_pad = max((A + a_tile - 1) // a_tile, 1) * a_tile
    atoms = np.zeros((4, A_pad), np.float32)
    atoms[:3] = PAD_ATOM
    atoms[:3, :A] = 0.0
    atoms[:dim, :A] = positions[order].T
    atoms[3, :A] = np.asarray(charges, np.float64)[order]

    # ---- per-block bounding boxes of the cells' LEVEL-0 ancestor boxes
    lvl = forest.level.astype(np.int64)
    LB = forest.lower + forest.h0 * (forest.ijk >> lvl[:, None])
    edges = np.arange(0, C, cpb)
    lo_blk = np.minimum.reduceat(LB, edges, axis=0) - cutoff
    hi_blk = np.maximum.reduceat(LB, edges, axis=0) + forest.h0 + cutoff
    nb_real = len(edges)

    # ---- candidate bucket ranges: the last bucket axis is contiguous in
    # the sorted order, so each (leading-axes combo) gives one slice
    blo = np.floor((lo_blk - borigin) / pitch).astype(np.int64)
    bhi = np.floor((hi_blk - borigin) / pitch).astype(np.int64)
    np.clip(blo, 0, shape - 1, out=blo)
    np.clip(bhi, 0, shape - 1, out=bhi)
    spans_lead = np.prod(bhi[:, :-1] - blo[:, :-1] + 1, axis=1)
    blk_rep = np.repeat(np.arange(nb_real), spans_lead)
    base = np.repeat(np.concatenate([[0], np.cumsum(spans_lead)[:-1]]),
                     spans_lead)
    local = np.arange(len(blk_rep)) - base
    lead = np.zeros((len(blk_rep), max(dim - 1, 1)), dtype=np.int64)
    rem = local
    for d in range(dim - 2, -1, -1):
        sp = bhi[blk_rep, d] - blo[blk_rep, d] + 1
        lead[:, d] = rem % sp
        rem //= sp
    lin_lo = np.zeros(len(blk_rep), dtype=np.int64)
    for d in range(dim - 1):
        lin_lo = lin_lo * shape[d] + (blo[blk_rep, d] + lead[:, d])
    lin_hi = lin_lo * shape[dim - 1] + bhi[blk_rep, dim - 1]
    lin_lo = lin_lo * shape[dim - 1] + blo[blk_rep, dim - 1]
    s0 = starts[lin_lo]
    s1 = starts[lin_hi + 1]
    keep = s1 > s0
    blk_rep, s0, s1 = blk_rep[keep], s0[keep], s1[keep]

    # ---- slices -> deduped (block, atom-tile) items, block-major CSR
    t0 = s0 // a_tile
    t1 = (s1 - 1) // a_tile
    n_t = (t1 - t0 + 1).astype(np.int64)
    item_blk = np.repeat(blk_rep, n_t)
    tbase = np.repeat(np.concatenate([[0], np.cumsum(n_t)[:-1]]), n_t)
    item_tile = np.repeat(t0, n_t) + (np.arange(len(item_blk)) - tbase)
    pair = np.unique(item_blk * np.int64(A_pad // a_tile) + item_tile)
    item_blk = pair // (A_pad // a_tile)
    item_tile = pair % (A_pad // a_tile)
    blk_ptr = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(item_blk, minlength=nb), out=blk_ptr[1:])

    # ---- padded integer cell table (pad cells pushed far away)
    cells = np.zeros((nb * cpb, dim + 1), dtype=np.int32)
    cells[:C, :dim] = forest.ijk
    cells[:C, dim] = forest.level
    cells[C:, :dim] = PAD_CELL
    return TilePlan(cpb=cpb, n_q=n_q, a_tile=a_tile, nb=nb,
                    blk_ptr=blk_ptr.astype(np.int32),
                    atile=item_tile.astype(np.int32), cells=cells,
                    atoms=atoms)


def build_geom(cells: torch.Tensor, pref: torch.Tensor, h0: float,
               lower0) -> tuple:
    """Quadrature points ``(3, n_cells * n_q)`` and level-0 ancestor lower
    corners ``(3, n_cells)`` in float32, from the integer cell table — the
    arithmetic of coulomb_gmg_tpu/ops/tile_density.py:_build_geom (exact:
    small integers times power-of-two-scaled h0)."""
    dim = cells.shape[1] - 1
    n, n_q = cells.shape[0], pref.shape[0]
    ijk = cells[:, :dim]
    lev = cells[:, dim]
    low0 = upload(np.asarray(lower0, np.float32), cells.device)
    scale = (h0 * torch.exp2(-lev.to(torch.float32)))[:, None]
    lower = low0 + ijk.to(torch.float32) * scale
    anc = low0 + (ijk >> lev[:, None]).to(torch.float32) * h0
    pts = lower[:, None, :] + scale[:, None] * pref[None]   # (n, n_q, dim)
    P = torch.zeros(3, n * n_q, dtype=torch.float32, device=cells.device)
    L = torch.zeros(3, n, dtype=torch.float32, device=cells.device)
    P[:dim] = pts.reshape(-1, dim).T
    L[:dim] = anc.T
    return P.contiguous(), L.contiguous()


def tile_density_plain(blk_ptr, atile, pts, anc, atoms, *, n_q: int,
                       cpb: int, a_tile: int, n_out: int, inv_rc2: float,
                       cut2: float, h0: float, scale: float) -> torch.Tensor:
    """Plain PyTorch version: dense masked (point x atom-tile) evaluation
    over chunks of work items, summed per block.  Returns ``(n_out, n_q)``
    float32."""
    dev = pts.device
    nb = blk_ptr.numel() - 1
    p_blk = cpb * n_q
    if n_out > nb * cpb:
        raise ValueError(f"tile_density: {n_out} output rows, plan covers "
                         f"{nb * cpb}")
    counts = (blk_ptr[1:] - blk_ptr[:-1]).long()
    blk_of = torch.repeat_interleave(torch.arange(nb, device=dev), counts)
    P = pts.reshape(3, nb, p_blk)
    Lq = anc.reshape(3, nb, cpb).repeat_interleave(n_q, dim=2)
    A = atoms.reshape(4, -1, a_tile)
    # tile columns past the last charged atom add exact zeros: drop them
    charged = torch.nonzero((A[3] != 0).any(0))
    width = int(charged.max()) + 1 if charged.numel() else 1
    A = A[:, :, :width]
    acc = torch.zeros(nb, p_blk, dtype=torch.float32, device=dev)
    step = max(1, (1 << 21) // (p_blk * width))
    for s in range(0, blk_of.numel(), step):
        b = blk_of[s:s + step]
        a = A[:, atile[s:s + step].long(), None, :]   # (4, m, 1, a_tile)
        d = a[:3] - P[:, b, :, None]                   # (3, m, p_blk, a_tile)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        lo = a[:3] - Lq[:, b, :, None]
        hi = lo - h0
        m = torch.minimum(lo * lo, hi * hi)
        m2 = m[0] + m[1] + m[2]
        e = torch.exp(-r2 * inv_rc2) * (m2 < cut2)
        acc.index_add_(0, b, (e * a[3]).sum(-1))
    return (acc.reshape(-1)[: n_out * n_q] * scale).reshape(n_out, n_q)


def member_counts(blk_ptr, atile, anc, atoms, *, cpb: int, a_tile: int,
                  cut2: float, h0: float) -> torch.Tensor:
    """Member atoms of every plan cell, ``(nb * cpb,)`` int64: the atoms of
    its block's tiles that pass the membership test (the float32 arithmetic
    of the kernel).  A cell's point needs ``n_q`` times as many terms.
    Plain PyTorch, for tests and work counts."""
    dev = anc.device
    nb = blk_ptr.numel() - 1
    counts = (blk_ptr[1:] - blk_ptr[:-1]).long()
    blk_of = torch.repeat_interleave(torch.arange(nb, device=dev), counts)
    L = anc.reshape(3, nb, cpb)
    A = atoms[:3].reshape(3, -1, a_tile)
    out = torch.zeros(nb, cpb, dtype=torch.int64, device=dev)
    step = max(1, (1 << 22) // (cpb * a_tile))
    for s in range(0, blk_of.numel(), step):
        b = blk_of[s:s + step]
        lo = A[:, atile[s:s + step].long(), None, :] - L[:, b, :, None]
        hi = lo - h0
        m = torch.minimum(lo * lo, hi * hi)
        out.index_add_(0, b, ((m[0] + m[1] + m[2]) < cut2).sum(-1))
    return out.reshape(-1)


_SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_float] * 4
        + [ctypes.c_void_p])


def tile_density_cuda(blk_ptr, atile, pts, anc, atoms, *, n_q: int,
                      cpb: int, a_tile: int, n_out: int, inv_rc2: float,
                      cut2: float, h0: float, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fall back).  It
    takes plans of ``A_TILE``-atom tiles only; the plain version takes any
    width."""
    nb = blk_ptr.numel() - 1
    ops = (blk_ptr, atile, pts, anc, atoms)
    if not all(t.is_cuda and t.is_contiguous() for t in ops):
        raise ValueError("tile_density_cuda: operands must be contiguous "
                         "tensors on the card")
    if blk_ptr.dtype != torch.int32 or atile.dtype != torch.int32:
        raise TypeError("tile_density_cuda: blk_ptr/atile must be int32")
    if not all(t.dtype == torch.float32 for t in (pts, anc, atoms)):
        raise TypeError("tile_density_cuda: pts/anc/atoms must be float32")
    if (cpb * n_q > P_TILE or a_tile != A_TILE
            or pts.shape != (3, nb * cpb * n_q)
            or anc.shape != (3, nb * cpb) or atoms.shape[0] != 4
            or atoms.shape[1] % a_tile or n_out > nb * cpb):
        raise ValueError("tile_density_cuda: inconsistent plan shapes")
    out = torch.empty(n_out, n_q, dtype=torch.float32, device=pts.device)
    lib = kernels.library("tile_density", {"tile_density_f32": _SIG})
    kernels.launch(
        lib.tile_density_f32, pts.device, "tile_density",
        blk_ptr.data_ptr(), atile.data_ptr(), pts.data_ptr(), anc.data_ptr(),
        atoms.data_ptr(), out.data_ptr(), nb, n_q, cpb, a_tile,
        atoms.shape[1], n_out, inv_rc2, cut2, h0, scale)
    tile_density.launches += 1
    return out


def tile_density(blk_ptr, atile, pts, anc, atoms, **kw) -> torch.Tensor:
    """Density on a tile plan: the CUDA kernel on the card, the plain
    version only for CPU tensors."""
    if pts.device.type == "cpu":
        return tile_density_plain(blk_ptr, atile, pts, anc, atoms, **kw)
    return tile_density_cuda(blk_ptr, atile, pts, anc, atoms, **kw)


tile_density.launches = 0     # kernel launches (CUDA path only)


def plan_operands(forest: Forest, points_ref, plan: TilePlan, r_c: float,
                  cutoff: float, device) -> tuple:
    """Device operands and constants of :func:`tile_density` for a plan:
    ``(args, kwargs)``.  Constants are rounded to float32 up front, as the
    TPU kernel saw them."""
    def put(a):
        return upload(np.ascontiguousarray(a), device)

    pref = put(np.asarray(points_ref, np.float32))
    pts, anc = build_geom(put(plan.cells), pref, float(forest.h0),
                          forest.lower)
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)    # as ops/density.py
    f32 = lambda v: float(np.float32(v))
    args = (put(plan.blk_ptr), put(plan.atile), pts, anc, put(plan.atoms))
    kw = dict(n_q=plan.n_q, cpb=plan.cpb, a_tile=plan.a_tile,
              inv_rc2=f32(1.0 / (r_c * r_c)), cut2=f32(cutoff * cutoff),
              h0=f32(forest.h0), scale=f32(const))
    return args, kw


def density_locality_tiles(forest: Forest, points_ref: np.ndarray,
                           positions: np.ndarray, charges: np.ndarray,
                           r_c: float, cutoff: float, device,
                           c_pad: Optional[int] = None,
                           a_tile: int = A_TILE) -> torch.Tensor:
    """rho~ per (cell, reference quadrature point) with the 4*pi
    normalization (src/step-50.cc:553-560), as a ``(c_pad, n_q)`` float32
    tensor on ``device``; rows past ``n_cells`` are exactly zero.
    ``c_pad`` defaults to ``n_cells + 1`` (StencilGMG's cell padding)."""
    n_q = len(points_ref)
    c_pad = forest.n_cells + 1 if c_pad is None else int(c_pad)
    if len(positions) == 0:
        return torch.zeros(c_pad, n_q, dtype=torch.float32, device=device)
    with span("density.plan"):
        plan = build_tile_plan(forest, n_q, positions, charges, cutoff,
                               a_tile=a_tile, n_rows=c_pad)
    with span("density.upload"):
        args, kw = plan_operands(forest, points_ref, plan, r_c, cutoff,
                                 device)
    with span("density.kernel"):
        return tile_density(*args, n_out=c_pad, **kw)
