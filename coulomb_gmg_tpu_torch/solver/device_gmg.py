"""Device-resident GMG-CG with operators built on the card.

Counterpart of coulomb_gmg_tpu/solver/device_gmg.py for the production
configuration (GaussianCharges, Q1, unit coefficient):

* every level operator (matrix, interface, transpose, prolongation,
  restriction, inverse diagonal, Chebyshev bounds) is built on the device
  from compact topology (ops/stencil.py); unchanged levels reuse the
  previous cycle's tensors through a content-keyed cache;
* the system matrix is never assembled: the outer CG runs the matrix-free
  ``cellwise_mv`` (solver/gmg.py);
* the RHS and the iterative-refinement defect run in native float64 on the
  card.  The TPU's double-float32 machinery (``_two_prod``,
  ``_neumaier_step``, ``_defect_dd``) has no counterpart: the H100 has
  float64.  Every accumulation is a gather over the transpose tables
  ``d2c`` and ``conT_*``, never an atomic scatter, so the RHS is the same
  from run to run (the published trajectory flips on ~3e-6 of RHS noise).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.utils.timer import span, spanned
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.mesh.dofs import DofInfo, Constraints
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.ops.dst import DSTPoisson
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.stencil import (
    stencil_table, level_topology, topology_signature, build_level_ops,
    build_prolongation_ops, power_lmax_device)
from coulomb_gmg_tpu_torch.solver.cg import host_float
from coulomb_gmg_tpu_torch.solver.fused import SteppedGMG
from coulomb_gmg_tpu_torch.solver.gmg import (
    pad_n, round_up, copy_map_tables, dst_tables, cellwise_mv, gmg_cg)

SMOOTHING_RANGE = 8.0     # Chebyshev targets [lmax / 8, lmax] of D^-1 A
IR_INNER_RTOL = 1e-6      # float32 CG floor of a refinement pass
IR_MAX_PASSES = 4


def copy_maps(forest: Forest, dofs: DofInfo):
    """Per-level (global dof ids, level dof ids) copy maps: dofs on ACTIVE
    level-l cells minus the refinement edge (copy_to_mg / copy_from_mg);
    int64 tensors on the forest's device."""
    out = []
    for ld in dofs.levels:
        _, active_index = forest.level_cells[ld.level]
        ldofs = torch.unique(ld.cell2dof[active_index >= 0])
        ldofs = ldofs[~ld.interface[ldofs]]
        gpos = torch.searchsorted(dofs.keys, ld.keys[ldofs])
        out.append((gpos, ldofs))
    return out


def constraint_ell(con: Constraints, k_mult: int = 4):
    """(rows, cols (ncon, Kc), weights, inhomog) dense-ELL form of the
    resolved constraints (Q1: hanging rows have <= 4 masters, Dirichlet
    rows none)."""
    ncon = len(con.rows)
    counts = np.diff(con.indptr)
    Kc = round_up(max(int(counts.max()) if ncon else 1, 1), k_mult)
    cols = np.zeros((ncon, Kc), np.int64)
    w = np.zeros((ncon, Kc), np.float64)
    if ncon:
        pos = np.arange(len(con.cols)) - np.repeat(con.indptr[:-1], counts)
        rowrep = np.repeat(np.arange(ncon), counts)
        cols[rowrep, pos] = con.cols
        w[rowrep, pos] = con.weights
    return con.rows, cols, w, con.inhomog


def _build_d2c(c2dT: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Transpose of cell2dof as a gather table (nb, n_pad): d2c[slot, i] is
    the flat position in the (nb * C_pad) transposed cell-value array of
    the slot-th entry contributing to dof i (a vertex touches <= 2^dim
    cells); dead slots point at the last pad-cell entry, whose value is
    always zero (hsc = 0)."""
    nb = c2dT.shape[0]
    flat = c2dT.reshape(-1).to(torch.int64)
    sortedv, order = torch.sort(flat, stable=True)
    rows = torch.arange(n_pad, device=flat.device)
    start = torch.searchsorted(sortedv, rows)
    pos = start[None, :] + torch.arange(nb, device=flat.device)[:, None]
    pos_c = pos.clamp(max=flat.numel() - 1)
    valid = (sortedv[pos_c] == rows[None, :]) & (pos < flat.numel())
    return torch.where(valid, order[pos_c],
                       flat.numel() - 1).to(torch.int32).contiguous()


def _build_con_tables(con_rows, con_cols, con_w, con_g, n_pad: int,
                      Kt: int):
    """Full-width gather tables of the constraint expansion, built once per
    topology (writes here have unique targets, so they are deterministic):
    con_mask (n_pad,), con_cols_full / con_w_full (Kc, n_pad) per-dof
    master expansion, g_full (n_pad,) inhomogeneity, conT_row / conT_w
    (Kt, n_pad) transposed expansion (master dof -> constrained rows)."""
    dev = con_rows.device
    ncon_pad, Kc = con_cols.shape
    dead = n_pad - 1
    real = con_rows != dead
    rows_r = con_rows[real]
    mask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    mask[rows_r] = True
    idx = torch.full((n_pad,), ncon_pad - 1, dtype=torch.int64, device=dev)
    idx[rows_r] = torch.nonzero(real).reshape(-1)
    ccf = con_cols[idx].T.to(torch.int32).contiguous()
    cwf = torch.where(mask[None, :], con_w[idx].T, 0.0).contiguous()
    gf = torch.zeros(n_pad, dtype=con_w.dtype, device=dev)
    gf[rows_r] = con_g[real]
    flat_cols = con_cols.reshape(-1)
    flat_w = con_w.reshape(-1)
    flat_row = con_rows.repeat_interleave(Kc)
    sc, order = torch.sort(flat_cols, stable=True)
    rows = torch.arange(n_pad, device=dev)
    start = torch.searchsorted(sc, rows)
    pos = start[None, :] + torch.arange(Kt, device=dev)[:, None]
    pos_c = pos.clamp(max=sc.numel() - 1)
    valid = ((sc[pos_c] == rows[None, :]) & (pos < sc.numel())
             & (rows[None, :] != dead))
    src = torch.where(valid, order[pos_c], sc.numel() - 1)
    tr = flat_row[src].to(torch.int32).contiguous()
    tw = torch.where(valid, flat_w[src], 0.0).contiguous()
    return mask, ccf, cwf, gf, tr, tw


def _raw_diag(d2c: torch.Tensor, hsc: torch.Tensor,
              kref: torch.Tensor) -> torch.Tensor:
    vals = (torch.diagonal(kref)[:, None] * hsc[None, :]).reshape(-1)
    return vals[d2c].sum(0)


class StencilGMG:
    """GMG-CG for one adaptive cycle with device-built operators.

    ``ops`` is the working-precision operator set consumed by
    solver/gmg.py; ``sys64`` holds the float64 system operands of the RHS
    assembly and the refinement defect.  ``fused`` (the driver's
    ``solve_fused``) runs every solve as the stepped solve of
    solver/fused.py, on the card CUDA graphs captured at the first solve
    and kept until :meth:`release`; ``fused=False`` runs the eager loop
    ``gmg_cg``, a measurement aid."""

    @spanned("mg.levels")
    def __init__(self, forest: Forest, dofs: DofInfo,
                 constraints: Constraints, device, dtype=torch.float32,
                 cache: Optional[dict] = None, coarse_maxiter: int = 500,
                 coarse_rtol: float = 1e-6, fused: bool = True):
        if dofs.degree != 1:
            raise NotImplementedError("StencilGMG is Q1-only")
        self.device = torch.device(device)
        self.dtype = dtype
        self.fused = fused
        self.stepped = None
        dim = forest.dim
        n = dofs.n_dofs
        self.n = n
        self.n_pad = pad_n(n)

        def put(a, dt=None):
            t = (a.to(self.device) if isinstance(a, torch.Tensor)
                 else upload(np.ascontiguousarray(a), self.device))
            return t if dt is None else t.to(dt)

        tab = element_tables(dim, 1, 2)
        T = put(stencil_table(dim, tab))
        kref = np.einsum("q,qij->ij", np.asarray(tab.weights, np.float64),
                         np.asarray(tab.grad_outer, np.float64))

        # ---- levels: build on device unless cached from an earlier cycle
        cache = {} if cache is None else cache
        touched = set()
        topos = [level_topology(forest, ld, l)
                 for l, ld in enumerate(dofs.levels)]
        sigs = [topology_signature(t) for t in topos]
        nl_pads = [pad_n(t.n) for t in topos]
        ents = []
        for l, t in enumerate(topos):
            key = ("slvl", sigs[l], str(dtype))
            touched.add(key)
            if key not in cache:
                cache[key] = self._build_level(t, nl_pads[l], T, dim, put,
                                               l)
            ents.append(cache[key])
        prs = [None]
        for l in range(1, len(topos)):
            key = ("spro", sigs[l], sigs[l - 1], str(dtype))
            touched.add(key)
            if key not in cache:
                cache[key] = build_prolongation_ops(
                    ents[l]["coords"], topos[l].n, ents[l - 1]["coords"],
                    topos[l - 1].n, dim=dim, side_c=topos[l - 1].side,
                    dtype=dtype)
            prs.append(cache[key])
        for k in [k for k in cache if k not in touched]:
            del cache[k]              # superseded fine levels

        cmaps = copy_maps(forest, dofs)
        cm_levels, src_lvl, src_idx = copy_map_tables(
            [g for g, _ in cmaps], [ld for _, ld in cmaps], self.n_pad,
            nl_pads, self.device)
        levels = []
        for l, ent in enumerate(ents):
            pr = prs[l]
            levels.append({
                "A": (ent["cols"], ent["evals"]),
                "inv_diag": ent["inv_diag"],
                "theta": ent["theta"], "delta": ent["delta"],
                "if": ((ent["cols"], ent["if_vals"])
                       if ent["if_vals"] is not None else None),
                "ifT": ((ent["cols"], ent["ifT_vals"])
                        if ent["ifT_vals"] is not None else None),
                "P": (pr[0], pr[1]) if pr is not None else None,
                "R": (pr[2], pr[3]) if pr is not None else None,
                "l2g": cm_levels[l][0], "cmask": cm_levels[l][1],
            })

        # ---- system operands (matrix-free outer matvec)
        c2d = put(dofs.cell2dof)
        C, nb = c2d.shape
        self.C_pad = C + 1            # one guaranteed pad cell (hsc = 0)
        dead = self.n_pad - 1
        c2d_pad = torch.full((self.C_pad, nb), dead, dtype=torch.int64,
                             device=self.device)
        c2d_pad[:C] = c2d
        h = forest.cell_h()
        hsc = np.zeros(self.C_pad)
        hsc[:C] = h ** (dim - 2)
        hdim = np.zeros(self.C_pad)
        hdim[:C] = h ** dim
        con_rows, con_cols, con_w, con_g = constraint_ell(constraints)
        ncon, Kc = len(con_rows), con_cols.shape[1]
        cr_pad = np.full(ncon + 1, dead, np.int64)       # >= 1 all-pad row
        cc_pad = np.full((ncon + 1, Kc), dead, np.int64)
        cw_pad = np.zeros((ncon + 1, Kc))
        cg_pad = np.zeros(ncon + 1)
        if ncon:
            counts = np.diff(constraints.indptr)
            filled = np.arange(Kc)[None, :] < counts[:, None]
            cr_pad[:ncon] = con_rows
            cc_pad[:ncon] = np.where(filled, con_cols, dead)
            cw_pad[:ncon] = con_w
            cg_pad[:ncon] = con_g
        Kt = 1
        if ncon and len(constraints.cols):
            Kt = max(int(np.bincount(constraints.cols).max()), 1)
        c2dT = c2d_pad.T.to(torch.int32).contiguous()
        d2c = _build_d2c(c2dT, self.n_pad)
        hsc_d, kref_d = put(hsc), put(kref)
        (con_mask, ccf, cwf, g_full, conT_row, conT_w) = _build_con_tables(
            put(cr_pad), put(cc_pad), put(cw_pad), put(cg_pad),
            n_pad=self.n_pad, Kt=Kt)
        self.sys64 = dict(c2d=c2dT, d2c=d2c, hsc=hsc_d, kref=kref_d,
                          con_mask=con_mask, con_cols_full=ccf,
                          con_w_full=cwf, conT_row=conT_row, conT_w=conT_w,
                          d_reg=_raw_diag(d2c, hsc_d, kref_d),
                          g_full=g_full, hdim=put(hdim))
        sys = {k: (v.to(dtype) if v.is_floating_point() else v)
               for k, v in self.sys64.items() if k not in ("g_full", "hdim")}

        # ---- coarse solve: the exact DST when level 0 is a full uniform
        # box of >= 3 cells per axis, else the Chebyshev-preconditioned CG
        # on level 0 to coarse_rtol / coarse_maxiter (solver/gmg.py)
        dst = None
        m0 = forest.base_reps
        if m0 >= 3:
            d = DSTPoisson.build(dim, m0, float(forest.h(0)),
                                 np.float32 if dtype == torch.float32
                                 else np.float64)
            coords0 = np.stack(np.meshgrid(*([np.arange(m0 + 1)] * dim),
                                           indexing="ij"), -1).reshape(-1, dim)
            interior = (coords0 > 0).all(1) & (coords0 < m0).all(1)
            dst = (put(d.S), put(d.lam),
                   *(put(a) for a in dst_tables(interior, nl_pads[0])))
        self.ops = {"sys": sys, "levels": levels, "src_lvl": src_lvl,
                    "src_idx": src_idx, "dst": dst, "dim": dim,
                    "coarse_rtol": coarse_rtol,
                    "coarse_maxiter": coarse_maxiter}
        self.b64 = None

    def _build_level(self, t, nl_pad, T, dim, put, l):
        coords_d = torch.full((nl_pad, dim), t.side + 1, dtype=torch.int32,
                              device=self.device)
        coords_d[: t.n] = put(t.coords)

        def padb(a):
            out = torch.zeros(nl_pad, dtype=a.dtype, device=self.device)
            out[: t.n] = put(a)
            return out

        want_if = l > 0 and bool(t.iface.any())
        out = build_level_ops(coords_d, padb(t.mask8), padb(t.elim),
                              padb(t.iface), padb(t.boundary), t.n, T,
                              dim=dim, side=t.side, h=t.h,
                              want_iface=want_if, dtype=self.dtype)
        cols, evals, inv_diag = out[:3]
        if_vals, ifT_vals = out[3:] if want_if else (None, None)
        lmax = host_float(power_lmax_device(cols, evals, inv_diag,
                                            t.n)) * 1.05
        lmin = lmax / SMOOTHING_RANGE
        return dict(cols=cols, evals=evals, inv_diag=inv_diag,
                    if_vals=if_vals, ifT_vals=ifT_vals,
                    theta=0.5 * (lmax + lmin), delta=0.5 * (lmax - lmin),
                    coords=coords_d)

    # ------------------------------------------------------------ solve

    def solve(self, rhs: torch.Tensor, x0: Optional[torch.Tensor] = None,
              rtol: float = 1e-6, maxiter: int = 100,
              rhs_norm: Optional[float] = None):
        """GMG-CG on a padded device rhs (n_pad,) in the working type.
        Returns (x (n_pad,), iterations, |r0|, |r|)."""
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        nb = (host_float(torch.linalg.vector_norm(rhs)) if rhs_norm is None
              else float(rhs_norm))
        if not self.fused:
            return gmg_cg(self.ops, rhs, x0, rtol * nb, maxiter)
        if self.stepped is None:
            self.stepped = SteppedGMG(self.ops, self.n_pad, self.dtype,
                                      self.device)
        return self.stepped.solve(rhs, x0, rtol * nb, maxiter)

    def release(self) -> None:
        """Drop the stepped solve's graphs and state (operators replaced)."""
        if self.stepped is not None:
            self.stepped.release()
            self.stepped = None

    # -------------------------------------------------------- float64 RHS

    def assemble_rhs(self, rho: torch.Tensor, tab_rhs) -> torch.Tensor:
        """Float64 RHS from the density at the quadrature points
        (src/step-50.cc:799-828 via fem/card_assembly.py's C^T form):
        ``rhs = C^T (f_raw - A_raw g)`` with constrained rows zeroed.

        rho: (C_pad, n_q) tensor on the device (rows past n_cells zero).
        Returns and keeps (as ``b64``) the padded (n_pad,) float64 rhs."""
        s = self.sys64
        if rho.shape[0] != self.C_pad:
            raise ValueError(f"rho has {rho.shape[0]} rows, expected "
                             f"{self.C_pad}")
        wphi = upload(np.asarray(tab_rhs.weights, np.float64)[:, None]
                      * np.asarray(tab_rhs.phi, np.float64), self.device)
        rho64 = rho.to(torch.float64)
        f = torch.zeros_like(s["c2d"], dtype=torch.float64)   # (nb, C_pad)
        for q in range(rho64.shape[1]):
            f = f + wphi[q][:, None] * rho64[:, q][None, :]
        lift = (s["kref"] @ s["g_full"][s["c2d"]]) * s["hsc"][None, :]
        fl = (f * s["hdim"][None, :] - lift).reshape(-1)
        z = fl[s["d2c"]].sum(0)
        rhs = z + ell_mv(s["conT_row"], s["conT_w"], z)
        self.b64 = torch.where(s["con_mask"], 0.0, rhs)
        return self.b64

    def defect64(self, x64: torch.Tensor) -> torch.Tensor:
        """Float64 ``b - A x`` with the exact assembled semantics;
        constrained rows are zero."""
        r = self.b64 - cellwise_mv(self.sys64, x64)
        return torch.where(self.sys64["con_mask"], 0.0, r)


def solve_refined_device(gmg: StencilGMG, x0: Optional[np.ndarray] = None,
                         rtol: float = 1e-8, maxiter: int = 100):
    """Mixed-precision iterative refinement against the float64 rhs
    ``gmg.b64``: float64 defect on the card, working-precision GMG-CG
    corrections, float64 accumulation of the solution.  Returns
    (x (n,) float64 on the card, total CG iterations, |r0|, |r_final|, CG
    iterations per pass); the norms are those of the TRUE float64
    defect.  Each pass is a span ``solve.cg`` of the run, each defect a
    span ``solve.check``."""
    b = gmg.b64
    with span("solve.check"):
        tol = rtol * host_float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    if x0 is not None:
        x[: gmg.n] = upload(np.asarray(x0, np.float64), b.device)
    passes = []
    res0 = None
    for p in range(IR_MAX_PASSES + 1):
        with span("solve.check"):
            r = gmg.defect64(x)
            rnorm = host_float(torch.linalg.vector_norm(r))
        if res0 is None:
            res0 = rnorm
        if rnorm <= tol or sum(passes) >= maxiter or p == IR_MAX_PASSES:
            break
        # a later pass needs only the remaining gain, not the float32 floor
        inner = min(max(IR_INNER_RTOL, 0.3 * tol / max(rnorm, 1e-300)), 0.1)
        with span("solve.cg"):
            d, k, _, _ = gmg.solve(r.to(gmg.dtype), rtol=inner,
                                   maxiter=maxiter, rhs_norm=rnorm)
            x = x + d.to(torch.float64)
        passes.append(k)
    return x[: gmg.n], sum(passes), res0, rnorm, passes
