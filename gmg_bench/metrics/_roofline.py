"""Least time one H100 could take for the work of each hand kernel, counted
from the problem; the frozen copy of the benchmark.

A launch's bound is the larger of its operations over the card's float32
rate outside the tensor cores and its bytes over the memory rate (NVIDIA's
data-sheet peaks of the H100 SXM at its 700 W limit; the run prints the
card's power limit beside them).  An FMA counts 2 operations, an
``exp`` 1.  Bytes count each input read once and each output written
once.  A kernel's share of its roofline is the sum of the bounds
of its launches over the sum of their device times.

Each kernel's work is counted by its own file, ``gmg_bench/kernels/
<kernel>.py`` (``bound_s``); here is the arithmetic they share.  Copied
from ``coulomb_gmg_tpu_torch/roofline.py``; where a count departs from the
program's copy, the kernel's file says how and why.
"""

from __future__ import annotations

import math

import torch

PEAK_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
OPS_DENSITY = 12          # 3 differences, r^2 (mul + 2 FMA), scale, exp, FMA
CHUNK = 1 << 24           # pairs per step of a count
STEP = 2048               # points per step of pairs_within
FAR_AWAY = 1.0e5          # coordinates beyond this are padding


def bound_s(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES)


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


def pairs_within(points: torch.Tensor, atoms: torch.Tensor,
                 r2: float) -> int:
    """The (point, atom) pairs closer than ``sqrt(r2)`` (strictly), by
    float64 differences, as a test of every pair would count them.  The
    points are sorted into boxes of a quarter of that radius and taken
    ``STEP`` at a time: an atom whose farthest distance from the step's
    bounding box is under the radius counts once for each of its points,
    one whose nearest distance is not under it counts for none, and only
    the atoms between are tested pair by pair.  Rounding is monotone, so
    the box tests agree with the pair test."""
    P = points.to(torch.float64)
    X = atoms.to(torch.float64)
    n, A = P.shape[0], X.shape[0]
    if n == 0 or A == 0:
        return 0
    pitch = 0.25 * math.sqrt(r2)
    box = torch.floor((P - P.amin(0)) / pitch).to(torch.int64)
    side = box.amax(0) + 1
    key = (box[:, 0] * side[1] + box[:, 1]) * side[2] + box[:, 2]
    P = P[torch.argsort(key)]
    total = torch.zeros((), dtype=torch.int64, device=P.device)
    for s in range(0, n, STEP):
        p = P[s:s + STEP]
        lo, hi = p.amin(0), p.amax(0)
        far = torch.maximum(X - lo, hi - X)
        gap = torch.clamp(torch.maximum(lo - X, X - hi), min=0.0)
        inside = (far * far).sum(-1) < r2
        total += inside.sum() * p.shape[0]
        c = X[((gap * gap).sum(-1) < r2) & ~inside]
        sub = max(1, CHUNK // p.shape[0])
        for t in range(0, c.shape[0], sub):
            d = p[:, None, :] - c[None, t:t + sub]
            total += ((d * d).sum(-1) < r2).sum()
    return int(total)


def share(ctx: dict, kernel: str):
    """Percent of the roofline of ``kernel`` over the traced solve: the
    bounds of its recorded launches (its file's ``bound_s``, a captured
    launch once a replay) over its device time; None where it made no
    launch or the trace holds no device time for it."""
    tr = ctx.get("trace")
    if not tr:
        return None
    t = tr["kernel_s"].get(kernel, 0.0)
    log = tr["log"]
    calls = log.calls.get(kernel, [])
    if t <= 0 or not calls:
        return None
    bound = log.kernels[kernel].bound_s
    total = 0.0
    for args, kw, graph in calls:
        total += log.weight(graph) * bound(args, kw)
    return 100.0 * total / t
