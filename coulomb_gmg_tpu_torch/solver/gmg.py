"""GMG-preconditioned CG on device-resident operators.

Counterpart of the solve half of coulomb_gmg_tpu/solver/tpu_gmg.py: the
matrix-free system matvec (``cellwise_mv``), the Chebyshev-Jacobi smoother
(``_cheb_t``), the exact DST coarse solve (``_coarse_apply``), the
Chebyshev-preconditioned coarse CG, and the V-cycle and outer CG of
``_fused_gmg_cg``, with both of its system operators.

The operator set is a plain dict with the layout of the JAX
``StencilGMG._fused_tree()``, so solver/device_gmg.py and convert.py build
the same thing:

* ``sys``: the matrix-free operands (device-operator mode, a dict): ``c2d``
  (nb, C_pad) int32, ``d2c`` (nb, n_pad) int32, ``hsc`` (C_pad,), ``kref``
  (nb, nb), ``con_mask`` (n_pad,) bool, ``con_cols_full`` / ``con_w_full``
  (Kc, n_pad), ``conT_row`` / ``conT_w`` (Kt, n_pad), ``d_reg`` (n_pad,);
  or the assembled system as one ELL pair (host-assembled path,
  solver/tpu_gmg.py);
* ``levels``: per level ``A`` / ``if`` / ``ifT`` / ``P`` / ``R`` as
  ``(cols, vals)`` ELL pairs of n_pad rows, padded (K, n_pad) when built on
  the device, sliced when built from a CSR (ops/ell.py; ``if``, ``ifT``,
  ``P`` and ``R`` may be None), ``inv_diag``, ``theta`` and ``delta``
  (floats),
  ``l2g`` and ``cmask`` (the gather-form copy maps);
* ``src_lvl`` / ``src_idx`` (n_pad,) int32: the gather-form copy back;
* ``dst``: (S, lam, interior, inv_map, int_mask, bnd_mask) and ``dim``; or
  None, and then ``coarse_rtol`` / ``coarse_maxiter`` of the coarse CG on
  level 0's ``A``.

Every accumulation is a gather over precomputed tables, never an atomic
scatter, so the solve is deterministic from run to run.  :func:`gmg_cg` and
:func:`coarse_cg` are the eager loops (``solve_fused=False``): host loops
that read one scalar (the residual norm) per iteration, through
:func:`~coulomb_gmg_tpu_torch.solver.cg.to_host`.  The default route,
solver/fused.py (the counterpart of the one-executable ``_fused_gmg_cg``),
runs the same arithmetic as a stepped solve on the device.  The TPU module's
bucket padding and blob packing have no counterpart: PyTorch runs eagerly,
there are no recompiles to dodge.
"""

from __future__ import annotations

import numpy as np
import torch

from coulomb_gmg_tpu_torch.ops.dst import dst_solve
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.solver.cg import to_host

CHEB_DEGREE = 4           # Chebyshev smoothing steps per V-cycle visit


def pad_n(n: int) -> int:
    """Vector length for ``n`` dofs: one guaranteed dead slot at the end
    (gather tables redirect pad entries to it)."""
    return n + 1


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def copy_map_tables(copy_global, copy_level, n_pad: int, nl_pads,
                    device="cpu"):
    """Gather-form copy maps (copy_to_mg / copy_from_mg), as
    coulomb_gmg_tpu/solver/tpu_gmg.py:copy_map_tables, as tensors on
    ``device`` (the maps may be tensors or numpy).  Returns per level
    (l2g (nl_pad,) with dead -> n_pad-1, cmask (nl_pad,) bool) plus the
    copy-back resolution (src_lvl (n_pad,) int32 with -1 = untouched,
    src_idx int32); later levels overwrite earlier ones."""
    dev = torch.device(device)
    levels = []
    src_lvl = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    src_idx = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for l, (gpos, ldofs) in enumerate(zip(copy_global, copy_level)):
        gpos = torch.as_tensor(gpos, device=dev)
        ldofs = torch.as_tensor(ldofs, device=dev)
        l2g = torch.full((nl_pads[l],), n_pad - 1, dtype=torch.int64,
                         device=dev)
        l2g[ldofs] = gpos.to(torch.int64)
        cmask = torch.zeros(nl_pads[l], dtype=torch.bool, device=dev)
        cmask[ldofs] = True
        levels.append((l2g, cmask))
        src_lvl[gpos] = l
        src_idx[gpos] = ldofs.to(torch.int32)
    return levels, src_lvl, src_idx


def dst_tables(interior: np.ndarray, n0_pad: int):
    """Gather-form DST coarse-solve index tables (see :func:`coarse_apply`):
    (interior ids, inv_map (n0_pad,), int_mask, bnd_mask)."""
    m = int(interior.sum())
    n_real = len(interior)
    inv_map = np.zeros(n0_pad, np.int64)
    inv_map[np.where(interior)[0]] = np.arange(m)
    int_mask = np.zeros(n0_pad, bool)
    int_mask[:n_real][interior] = True
    bnd_mask = np.zeros(n0_pad, bool)
    bnd_mask[:n_real][~interior] = True
    return np.where(interior)[0], inv_map, int_mask, bnd_mask


def cellwise_mv(s: dict, v: torch.Tensor) -> torch.Tensor:
    """Matrix-free matvec of the assembled system: constraint expansion C,
    the raw cell pass (gather by cell2dof, K_ref contraction, gather-sum
    over the transposed table d2c), C^T, and the regularization diagonal on
    constrained rows — the assembled semantics of
    fem/assembly.py:assemble_np without the CSR."""
    wr = ell_mv(s["con_cols_full"], s["con_w_full"], v)
    w = torch.where(s["con_mask"], wr, v)
    ylT = (s["kref"] @ w[s["c2d"]]) * s["hsc"][None, :]     # (nb, C_pad)
    z = ylT.reshape(-1)[s["d2c"]].sum(0)
    y = z + ell_mv(s["conT_row"], s["conT_w"], z)
    return torch.where(s["con_mask"], s["d_reg"] * v, y)


def sys_mv(s, v: torch.Tensor) -> torch.Tensor:
    """The system operator: matrix-free operands (dict) or an ELL pair."""
    if isinstance(s, dict):
        return cellwise_mv(s, v)
    return ell_mv(*s, v)


def cheb(A, inv_diag, d, x0, theta: float, delta: float, degree: int,
         from_zero: bool):
    """Chebyshev iteration for A x = d on the spectrum
    [theta - delta, theta + delta] of D^{-1} A; ``from_zero`` skips the
    first residual (x0 ignored)."""
    cols, vals = A
    r = inv_diag * (d if from_zero else d - ell_mv(cols, vals, x0))
    p = r / theta
    x = p if from_zero else x0 + p
    sigma = theta / delta
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        r = inv_diag * (d - ell_mv(cols, vals, x))
        rho = 1.0 / (2.0 * sigma - rho_old)
        p = rho * rho_old * p + (2.0 * rho / delta) * r
        x = x + p
        rho_old = rho
    return x


def coarse_apply(dst, d, inv_diag, dim: int):
    """DST direct coarse solve: interior nodes exactly, eliminated
    (boundary) rows through their regularization diagonal; the result is
    written back by gather (inv_map) and masks."""
    S, lam, interior, inv_map, int_mask, bnd_mask = dst
    b = d[interior].reshape((S.shape[0],) * dim)
    uf = dst_solve(S, lam, b).reshape(-1)
    out = torch.where(int_mask, uf[inv_map.clamp(max=uf.numel() - 1)], 0.0)
    return torch.where(bnd_mask, d * inv_diag, out)


def _smooth(lv, d, u0, from_zero):
    return cheb(lv["A"], lv["inv_diag"], d, u0, lv["theta"], lv["delta"],
                CHEB_DEGREE, from_zero)


def coarse_cg(ops: dict, d0: torch.Tensor) -> torch.Tensor:
    """Chebyshev-preconditioned CG on level 0 to ``coarse_rtol * |d0|``
    or ``coarse_maxiter`` iterations (the coarse branch of the fused TPU
    executable); one scalar read per iteration."""
    lv = ops["levels"][0]
    x = torch.zeros_like(d0)
    r = d0
    tol2 = ops["coarse_rtol"] ** 2 * to_host(torch.dot(r, r))
    z = _smooth(lv, r, None, True)
    p = z
    rho = torch.dot(r, z)
    r2 = to_host(torch.dot(r, r))
    k = 0
    while r2 > tol2 and k < ops["coarse_maxiter"]:
        q = ell_mv(*lv["A"], p)
        alpha = _safe_div(rho, torch.dot(p, q))
        x = x + alpha * p
        r = r - alpha * q
        z = _smooth(lv, r, None, True)
        rho_new = torch.dot(r, z)
        p = z + _safe_div(rho_new, rho) * p
        rho = rho_new
        r2 = to_host(torch.dot(r, r))
        k += 1
    return x


def vcycle_down(ops: dict, g: torch.Tensor):
    """The first half of a V-cycle on the residual ``g``: copy to the
    levels (pure gathers), pre-smooth and restrict down to level 0.
    Returns (defect per level, smoothed solution per level, None at 0)."""
    levels = ops["levels"]
    L = len(levels) - 1
    defect = [torch.where(lv["cmask"], g[lv["l2g"]], 0.0) for lv in levels]
    sol = [None] * (L + 1)
    for l in range(L, 0, -1):
        lv = levels[l]
        u = _smooth(lv, defect[l], None, True)
        r = defect[l] - ell_mv(*lv["A"], u)
        if lv["if"] is not None:
            r = r - ell_mv(*lv["if"], u)
        defect[l - 1] = defect[l - 1] + ell_mv(*lv["R"], r)
        sol[l] = u
    return defect, sol


def vcycle(ops: dict, g: torch.Tensor) -> torch.Tensor:
    """One V-cycle (pre-smooth, restrict, exact coarse solve, prolongate,
    post-smooth) on the residual ``g``; copy to and from the levels are
    pure gathers."""
    defect, sol = vcycle_down(ops, g)
    if ops["dst"] is not None:
        sol[0] = coarse_apply(ops["dst"], defect[0],
                              ops["levels"][0]["inv_diag"], ops["dim"])
    else:
        sol[0] = coarse_cg(ops, defect[0])
    return vcycle_up(ops, defect, sol, g)


def vcycle_up(ops: dict, defect, sol, g: torch.Tensor) -> torch.Tensor:
    """The second half of a V-cycle: prolongate from the coarse solution
    ``sol[0]``, post-smooth, and copy back to the layout of ``g``."""
    levels = ops["levels"]
    L = len(levels) - 1
    for l in range(1, L + 1):
        lv = levels[l]
        u = sol[l] + ell_mv(*lv["P"], sol[l - 1])
        d = defect[l]
        if lv["ifT"] is not None:
            d = d - ell_mv(*lv["ifT"], u)
        sol[l] = _smooth(lv, d, u, False)
    out = torch.zeros_like(g)
    for l in range(L + 1):
        idx = ops["src_idx"].clamp(max=sol[l].numel() - 1)
        out = torch.where(ops["src_lvl"] == l, sol[l][idx], out)
    return out


def _safe_div(a, b):
    return torch.where(b != 0, a / torch.where(b != 0, b, 1.0), 0.0)


def tol_squared(tol: float, dtype: torch.dtype) -> torch.Tensor:
    """``tol**2`` as the stopping test compares it: ``tol`` rounded to the
    working type and squared there (a CPU scalar)."""
    t = torch.tensor(tol, dtype=dtype)
    return t * t


def gmg_cg(ops: dict, rhs: torch.Tensor, x0: torch.Tensor, tol: float,
           maxiter: int):
    """GMG-preconditioned CG until ``|r| <= tol`` or ``maxiter``
    iterations.  Returns (x, iterations, |r0|, |r|); the two norms are
    floats.  The stopping test compares float32-rounded quantities when the
    working type is float32, as the fused TPU executable does."""
    r = rhs - sys_mv(ops["sys"], x0)
    res2 = torch.dot(r, r)
    tol2 = float(tol_squared(tol, rhs.dtype))
    z = vcycle(ops, r)
    p = z
    rho = torch.dot(r, z)
    x = x0
    res2_h = to_host(res2)
    res0 = res2_h ** 0.5
    k = 0
    while k < maxiter and res2_h > tol2:
        q = sys_mv(ops["sys"], p)
        alpha = _safe_div(rho, torch.dot(p, q))
        x = x + alpha * p
        r = r - alpha * q
        z = vcycle(ops, r)
        rho_new = torch.dot(r, z)
        p = z + _safe_div(rho_new, rho) * p
        rho = rho_new
        res2_h = to_host(torch.dot(r, r))     # the one read per iteration
        k += 1
    return x, k, res0, res2_h ** 0.5
