"""Least time one H100 could take for the work of each hand kernel, counted
from the problem; the frozen copy of the benchmark.

A launch's bound is the larger of its operations over the card's float32
rate outside the tensor cores and its bytes over the memory rate (NVIDIA's
data-sheet peaks of the H100 SXM at its 700 W limit; the run prints the
card's power limit beside them).  An FMA counts 2 operations, an
``exp`` 1.  Bytes count each input read once and each output written
once.  A kernel's share of its roofline is the sum of the bounds
of its launches over the sum of their device times.

Copied from ``coulomb_gmg_tpu_torch/roofline.py`` with one difference: the
tile kernel's work is counted from the cells and the atoms alone.  Its
terms are the member (point, atom) pairs of the locality cut, each cell's
members found here from its level-0 ancestor and the atoms, and its bytes
are the atoms, the quadrature points' coordinates and the output.  The
program's copy takes the bytes of every operand, the plan arrays
(``blk_ptr``, ``atile``, ``anc``) with them, so a change of the plan would
move the bound; here it does not.
"""

from __future__ import annotations

import math

import torch

PEAK_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
OPS_DENSITY = 12          # 3 differences, r^2 (mul + 2 FMA), scale, exp, FMA
CHUNK = 1 << 24           # pairs per step of a count
FAR_AWAY = 1.0e5          # coordinates beyond this are padding


def bound_s(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


def ell_spmv(cols, vals: torch.Tensor, x: torch.Tensor, nnz: int) -> float:
    """One FMA, its value and a 4-byte column per nonzero; x read, y
    written."""
    rows = cols.n_rows if hasattr(cols, "n_rows") else cols.shape[-1]
    return bound_s(2 * nnz, nnz * (4 + vals.element_size())
                   + (x.numel() + rows) * x.element_size())


def member_counts(lower: torch.Tensor, h0: float, pos: torch.Tensor,
                  cut2: float) -> torch.Tensor:
    """Atoms within ``sqrt(cut2)`` of any vertex of each box ``lower +
    [0, h0]^3`` (strictly), counted on a grid of pitch ``h0`` through the
    atoms' windows; boxes off that grid are counted one by one."""
    dev = lower.device
    lo = lower.to(torch.float64)
    P = pos.to(torch.float64)
    origin = lo.amin(0)
    g = torch.round((lo - origin) / h0)
    on_grid = ((origin + h0 * g) == lo).all(-1)
    g = g.to(torch.int64)
    n = g.amax(0) + 1
    lin = (g[:, 0] * n[1] + g[:, 1]) * n[2] + g[:, 2]
    grid = torch.zeros(int(n.prod()), dtype=torch.int64, device=dev)
    w = int(math.ceil(math.sqrt(cut2) / h0)) + 2
    r = torch.arange(-w, w + 1, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    home = torch.floor((P - origin) / h0).to(torch.int64)
    step = max(1, CHUNK // offs.shape[0])
    for s in range(0, P.shape[0], step):
        c = home[s:s + step, None, :] + offs[None]
        inside = ((c >= 0) & (c < n)).all(-1)
        d = P[s:s + step, None, :] - (origin + h0 * c.to(torch.float64))
        e = d - h0
        near = torch.minimum(d * d, e * e).sum(-1) < cut2
        cc = c[inside & near]
        at = (cc[:, 0] * n[1] + cc[:, 1]) * n[2] + cc[:, 2]
        grid.index_add_(0, at, torch.ones_like(at))
    counts = torch.where(on_grid, grid[lin.clamp(0, grid.numel() - 1)], 0)
    for i in torch.nonzero(~on_grid).squeeze(1).tolist():
        d = P - lo[i]
        e = d - h0
        counts[i] = int((torch.minimum(d * d, e * e).sum(-1) < cut2).sum())
    return counts


def tile_density(args, kw) -> float:
    """12 operations per member (point, atom) term; the atoms, the points'
    coordinates and the output."""
    _, _, _, anc, atoms = args
    n_q = kw["n_q"]
    lower = anc.T
    real = lower.abs().amax(-1) < FAR_AWAY
    X = atoms[:3].T
    live = X.abs().amax(-1) < FAR_AWAY
    members = int(member_counts(lower[real], kw["h0"], X[live],
                                kw["cut2"]).sum())
    n_out = kw["n_out"]
    n_bytes = int(live.sum()) * 16 + (n_out * n_q * 3 + n_out * n_q) * 4
    return bound_s(OPS_DENSITY * members * n_q, n_bytes)


def share(ctx: dict, kernel: str):
    """Percent of the roofline of ``kernel`` over the traced solve; None
    where it made no launch or the trace holds no device time for it."""
    tr = ctx.get("trace")
    if not tr:
        return None
    t = tr["kernel_s"].get(kernel, 0.0)
    calls = tr["log"].calls.get(kernel, [])
    if t <= 0 or not calls:
        return None
    weight = tr["log"].weight
    total = 0.0
    if kernel == "ell_spmv":
        nnz = {}
        for (cols, vals, x), _, graph in calls:
            if id(vals) not in nnz:
                nnz[id(vals)] = int(torch.count_nonzero(vals))
            total += weight(graph) * ell_spmv(cols, vals, x, nnz[id(vals)])
    else:
        for args, kw, graph in calls:
            total += weight(graph) * tile_density(args, kw)
    return 100.0 * total / t
