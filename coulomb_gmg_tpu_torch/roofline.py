"""Least time one H100 could take for the work of each hand kernel.

``bound_ms`` is the larger of two times: the operations over the card's
float32 rate outside the tensor cores (67 TFLOP/s) and the bytes over its
memory rate (3.35 TB/s), both NVIDIA's data-sheet peaks of the H100 SXM at
its 700 W limit.  An FMA counts 2 operations; an ``exp``, ``erf`` or
``rsqrt`` counts 1.  Bytes count each input read once and each output
written once.  Work counts only what the given inputs need to change the
output: the member (point, atom) terms of the locality cut, the (point,
atom) pairs of the brute-force density whose float32 ``exp`` is not zero,
the nonzero slots of the ELL operator, and every (point, atom) pair of the
exact gradient, near ones at the full formula's cost.
"""

from __future__ import annotations

import torch

PEAK_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
# float32 operations per (point, atom) term
OPS_DENSITY = 12          # 3 differences, r^2 (mul + 2 FMA), scale, exp, FMA
OPS_GRAD_FAR = 18         # 3 differences, r^2, rsqrt, r^-3 (2 muls), q r^-3,
                          # 3 FMAs
OPS_GRAD_NEAR = 27        # the far terms + r, r / r_c, its square, exp, erf,
                          # the bracket (mul + FMA) and its product
CHUNK = 1 << 24           # (point, atom) pairs per step of a pair count


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, n_bytes: float) -> dict:
    """``{"bound_ms", "bound_by", "ops", "bytes"}`` for one launch."""
    t_ops, t_bytes = ops / PEAK_FP32, n_bytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "ops": float(ops), "bytes": float(n_bytes)}


def tile_density(args, kw, out: torch.Tensor) -> dict:
    """The member terms of the plan (``n_q`` per member (cell, atom))."""
    from coulomb_gmg_tpu_torch.ops.tile_density import member_counts
    blk_ptr, atile, _, anc, atoms = args
    members = int(member_counts(blk_ptr, atile, anc, atoms, cpb=kw["cpb"],
                                a_tile=kw["a_tile"], cut2=kw["cut2"],
                                h0=kw["h0"]).sum()) * kw["n_q"]
    return {**bound(OPS_DENSITY * members, nbytes(*args, out)),
            "terms": members}


def ell_spmv(cols, vals: torch.Tensor, x: torch.Tensor) -> dict:
    """One FMA, a column and a value per nonzero slot, in either layout
    (ops/ell.py; the same work for both); x read, y written."""
    from coulomb_gmg_tpu_torch.ops.ell import Slices
    if isinstance(cols, Slices):
        cols = cols.cols
    nnz = int((vals != 0).sum())
    return {**bound(2 * nnz, nnz * (cols.element_size() + vals.element_size())
                    + nbytes(x, x)), "terms": nnz}


def dense_density(args, kw, out: torch.Tensor) -> dict:
    """The (point, atom) pairs whose float32 ``exp(-r^2 inv_rc2)`` is not
    zero; past r^2 / r_c^2 ~ 104 it underflows and the term adds nothing.
    The points are formed as the kernel forms them; counted in chunks on the
    tensors' device."""
    lower, h, pref, atoms = args
    X = atoms[:, :3]
    step = max(1, CHUNK // max(pref.shape[0] * atoms.shape[0], 1))
    live = 0
    for s in range(0, lower.shape[0], step):
        p = lower[s:s + step, None, :] + h[s:s + step, None, None] * pref
        d = p.reshape(-1, 1, 3) - X
        live += int((torch.exp(-(d * d).sum(-1) * kw["inv_rc2"]) != 0).sum())
    return {**bound(OPS_DENSITY * live, nbytes(*args, out)), "terms": live,
            "pairs": lower.shape[0] * pref.shape[0] * atoms.shape[0]}


def exact_gradient(points: torch.Tensor, atoms: torch.Tensor,
                   far_r2: float) -> dict:
    """Far pairs (``r^2 >= far_r2``) at the far cost, the others at the
    full formula's; counted in float32 chunks on the tensors' device."""
    X = atoms[:, :3]
    step = max(1, CHUNK // max(atoms.shape[0], 1))
    near = 0
    for s in range(0, points.shape[0], step):
        d = points[s:s + step, None, :] - X
        near += int(((d * d).sum(-1) < far_r2).sum())
    pairs = points.shape[0] * atoms.shape[0]
    ops = OPS_GRAD_FAR * (pairs - near) + OPS_GRAD_NEAR * near
    return {**bound(ops, nbytes(points, atoms, points)), "terms": pairs,
            "near": near}
