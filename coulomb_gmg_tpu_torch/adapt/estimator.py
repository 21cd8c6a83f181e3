"""Kelly face-jump error estimator and threshold marking, in float64.

Counterpart of coulomb_gmg_tpu/adapt/estimator.py (the reference's
``estimate_error_and_mark_cells``, src/step-50.cc:1020-1090), as torch code
on the forest's device: the face plan is built once and updated
incrementally across refinements, and the jump integrals and the optional
volume term are float64.  Every sum runs over its terms in a fixed order
(a product's terms in index order, a cell's contributions in face order
through a stable sort, never an atomic), so a run gives the same bits
every time, and the card agrees with the CPU to the last bits (rel 1e-14;
``chip_smoke.py`` phase 16).  Marking is threshold-sensitive (0.6 * max),
which is why it stays in float64.

On a card every selection of a data-dependent size makes the host wait, so
each selection is one ``torch.nonzero`` over a whole level, axis or face
group (never per cell, never an early-exit test), and the estimate sums
every face contribution in one segment reduction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.dofs import HostView
from coulomb_gmg_tpu_torch.mesh.forest import Forest, active_level_index
from coulomb_gmg_tpu_torch.ops.q1 import face_tables, _basis_at
from coulomb_gmg_tpu_torch.utils.timer import span


@dataclass
class FacePlan:
    """Precomputed interior-face groups for one mesh topology; int64
    tensors on the forest's device."""

    # same-level faces: cells (m,), neighbor (m,), axis (m,)
    sl_a: torch.Tensor
    sl_b: torch.Tensor
    sl_axis: torch.Tensor
    # coarse-fine faces: fine cell, coarse cell, axis, fine side (0: fine
    # face at low side), subface config id in [0, 2^(dim-1))
    cf_fine: torch.Tensor
    cf_coarse: torch.Tensor
    cf_axis: torch.Tensor
    cf_side: torch.Tensor
    cf_sub: torch.Tensor

    @cached_property
    def host(self) -> HostView:
        """numpy view for host consumers (the sharded estimator)."""
        return HostView(self)


def _plan(dev, sl_a, sl_b, sl_axis, cf_fine, cf_coarse, cf_axis, cf_side,
          cf_sub) -> FacePlan:
    cat = lambda xs: (torch.cat(xs) if xs
                      else torch.zeros(0, dtype=torch.int64, device=dev))
    return FacePlan(sl_a=cat(sl_a), sl_b=cat(sl_b), sl_axis=cat(sl_axis),
                    cf_fine=cat(cf_fine), cf_coarse=cat(cf_coarse),
                    cf_axis=cat(cf_axis), cf_side=cat(cf_side),
                    cf_sub=cat(cf_sub))


def _subface(ijk: torch.Tensor, free) -> torch.Tensor:
    sub = torch.zeros(len(ijk), dtype=torch.int64, device=ijk.device)
    for k, d in enumerate(free):
        sub |= (ijk[:, d] & 1) << k
    return sub


def build_face_plan(forest: Forest) -> FacePlan:
    dim = forest.dim
    lvl = forest.level_t
    per_level = active_level_index(forest)

    sl_a, sl_b, sl_axis = [], [], []
    cf_fine, cf_coarse, cf_axis, cf_side, cf_sub = [], [], [], [], []

    for l in range(forest.n_levels):
        cells = torch.nonzero(lvl == l).reshape(-1)
        if len(cells) == 0:
            continue
        ijk = forest.ijk_t[cells]
        side_n = forest.side(l)
        ki, act = per_level[l]
        for axis in range(dim):
            # same-level faces, + direction only (each counted once)
            nb = ijk.clone()
            nb[:, axis] += 1
            inside = nb[:, axis] < side_n
            pos = ki.lookup(forest.level_cell_key(l, nb))
            at = torch.nonzero(inside & (pos >= 0)).reshape(-1)
            a = cells[at]
            sl_a.append(a)
            sl_b.append(act[pos[at]])
            sl_axis.append(torch.full_like(a, axis))
            if l == 0:
                continue
            # coarse neighbors across +/- faces
            kc, actc = per_level[l - 1]
            for sgn, sidev in ((1, 1), (-1, 0)):
                nb = ijk.clone()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side_n)
                parent = nb >> 1
                posc = kc.lookup(forest.level_cell_key(l - 1, parent))
                # only when the same-level neighbor does NOT exist
                pos_same = ki.lookup(forest.level_cell_key(l, nb))
                at = torch.nonzero(inside & (pos_same < 0)
                                   & (posc >= 0)).reshape(-1)
                fine = cells[at]
                cf_fine.append(fine)
                cf_coarse.append(actc[posc[at]])
                cf_axis.append(torch.full_like(fine, axis))
                cf_side.append(torch.full_like(fine, sidev))
                cf_sub.append(_subface(ijk[at],
                                       [d for d in range(dim) if d != axis]))

    return _plan(lvl.device, sl_a, sl_b, sl_axis, cf_fine, cf_coarse,
                 cf_axis, cf_side, cf_sub)


def update_face_plan(old: Forest, new: Forest, old_plan: FacePlan,
                     omap: torch.Tensor) -> FacePlan:
    """Incremental FacePlan across one refinement step.

    Only faces incident to refined cells change: faces between two
    SURVIVING cells are kept (indices remapped through the old->new
    covering map ``omap``); faces incident to NEW cells (children) are
    discovered by scanning just the new cells — both face directions, with
    ownership rules that add each face exactly once:

    * new-new same-level: counted from the + direction (as in the full
      builder);
    * new-surviving same-level: counted from the new side (the surviving
      side is not scanned);
    * coarse-fine with a NEW fine cell: counted from the fine side;
    * coarse-fine with a SURVIVING fine cell and new coarse cell: counted
      from the coarse side (fine side not scanned) — the 2:1 balance
      guarantees those fine subcells are active.

    Replaces the full O(n_cells) rebuild per cycle with O(new cells) work
    (plus per-level key sorts of the new forest); the reference pays this
    cost inside KellyErrorEstimator on every cycle
    (src/step-50.cc:1020-1090)."""
    dim = new.dim
    dev = omap.device
    lvl = new.level_t
    survived_new = lvl == old.level_t[omap]              # per NEW cell
    new_of_old = torch.full((old.n_cells,), -1, dtype=torch.int64,
                            device=dev)
    surv_idx = torch.nonzero(survived_new).reshape(-1)
    new_of_old[omap[surv_idx]] = surv_idx
    old_survived = new_of_old >= 0                       # per OLD cell

    # ---- keep remapped faces between surviving cells
    keep_sl = torch.nonzero(old_survived[old_plan.sl_a]
                            & old_survived[old_plan.sl_b]).reshape(-1)
    sl_a = [new_of_old[old_plan.sl_a[keep_sl]]]
    sl_b = [new_of_old[old_plan.sl_b[keep_sl]]]
    sl_axis = [old_plan.sl_axis[keep_sl]]
    keep_cf = torch.nonzero(old_survived[old_plan.cf_fine]
                            & old_survived[old_plan.cf_coarse]).reshape(-1)
    cf_fine = [new_of_old[old_plan.cf_fine[keep_cf]]]
    cf_coarse = [new_of_old[old_plan.cf_coarse[keep_cf]]]
    cf_axis = [old_plan.cf_axis[keep_cf]]
    cf_side = [old_plan.cf_side[keep_cf]]
    cf_sub = [old_plan.cf_sub[keep_cf]]

    per_level = active_level_index(new)
    ki_of = lambda l: per_level.get(l)

    is_new = ~survived_new
    new_cells = torch.nonzero(is_new).reshape(-1)
    new_lvl = lvl[new_cells]
    for l in torch.unique(new_lvl).tolist():
        cells = new_cells[torch.nonzero(new_lvl == l).reshape(-1)]
        ijk = new.ijk_t[cells]
        side_n = new.side(l)
        ki, act = ki_of(l)
        for axis in range(dim):
            free = [d for d in range(dim) if d != axis]
            for sgn in (1, -1):
                nb = ijk.clone()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side_n)
                pos = ki.lookup(new.level_cell_key(l, nb))
                pos = torch.where(inside, pos, -1)
                same = pos >= 0
                # new-new: + direction only; new-surviving: always.
                # Orientation: sl_a is the cell on the LOW side of the face
                # (the full builder scans + direction only).
                other = act[pos.clamp(min=0)]
                at = torch.nonzero(same & (~is_new[other] | (sgn == 1))
                                   ).reshape(-1)
                here, there = cells[at], other[at]
                a = here if sgn == 1 else there
                b = there if sgn == 1 else here
                sl_a.append(a)
                sl_b.append(b)
                sl_axis.append(torch.full_like(a, axis))
                # coarse neighbor (fine side = this new cell)
                rem = inside & ~same
                if l > 0 and ki_of(l - 1) is not None:
                    kc, actc = ki_of(l - 1)
                    posc = kc.lookup(new.level_cell_key(l - 1, nb >> 1))
                    hit = torch.nonzero(rem & (posc >= 0)).reshape(-1)
                    fc = cells[hit]
                    cf_fine.append(fc)
                    cf_coarse.append(actc[posc[hit]])
                    cf_axis.append(torch.full_like(fc, axis))
                    cf_side.append(torch.full_like(fc, 1 if sgn == 1
                                                   else 0))
                    cf_sub.append(_subface(new.ijk_t[fc], free))
                    rem = rem & (posc < 0)
                # finer neighbors (coarse side = this new cell); add only
                # SURVIVING fine subcells — new fine cells add the face
                # from their own scan
                if ki_of(l + 1) is None or len(ki_of(l + 1)[1]) == 0:
                    continue
                kf, actf = ki_of(l + 1)
                base = nb * 2
                # subcells on the face adjacent to this cell: axis
                # coordinate pinned to the NEAR side of the neighbor
                base[:, axis] = 2 * nb[:, axis] + (0 if sgn == 1 else 1)
                subs = []
                for subcfg in range(2 ** (dim - 1)):
                    sub_ijk = base.clone()
                    for k, d in enumerate(free):
                        sub_ijk[:, d] += (subcfg >> k) & 1
                    subs.append(sub_ijk)
                posf = kf.lookup(new.level_cell_key(l + 1, torch.stack(subs)))
                fine = actf[posf.clamp(min=0)]
                # (subface config, cell) pairs in the order of the configs
                sc, i = torch.nonzero(rem & (posf >= 0) & ~is_new[fine],
                                      as_tuple=True)
                f = fine[sc, i]
                cf_fine.append(f)
                cf_coarse.append(cells[i])
                cf_axis.append(torch.full_like(f, axis))
                # the fine cell sees its coarse neighbor in the -sgn
                # direction
                cf_side.append(torch.full_like(f, 1 if sgn == -1 else 0))
                cf_sub.append(_subface(new.ijk_t[f], free))

    return _plan(dev, sl_a, sl_b, sl_axis, cf_fine, cf_coarse, cf_axis,
                 cf_side, cf_sub)


def _face_grad_tables(dim: int, degree: int, n_q1: int):
    """Reference-gradient tables at face quadrature points.

    Returns:
      grads[face] : (n_fq, nb, dim) for the cell's own face points
      sub_grads[(face, sub)] : coarse-cell gradients at the image of the
        fine subface's quadrature points.
    """
    ft = face_tables(dim, degree, n_q1)
    grads = [g for (_, _, _, g) in ft]
    weights = [w for (_, w, _, _) in ft]
    pts = [p for (p, _, _, _) in ft]
    sub_grads = {}
    for f in range(2 * dim):
        axis, side = f // 2, f % 2
        free = [d for d in range(dim) if d != axis]
        p = pts[f]
        for sub in range(2 ** (dim - 1)):
            q = p.copy()
            for k, d in enumerate(free):
                q[:, d] = 0.5 * (p[:, d] + ((sub >> k) & 1))
            # the coarse cell sees the face from the OPPOSITE side
            q[:, axis] = 1.0 - side
            sub_grads[(f, sub)] = _basis_at(dim, degree, q)[1]
    return grads, weights, sub_grads


def _products(x: torch.Tensor, G) -> torch.Tensor:
    """``x @ G.T`` for x (m, k) and a numpy table G (r, k), each output
    summing its k terms in index order (no reduction of unspecified
    order)."""
    G = upload(np.ascontiguousarray(G, np.float64), x.device)
    acc = x[:, None, 0] * G[None, :, 0]
    for j in range(1, G.shape[1]):
        acc = acc + x[:, None, j] * G[None, :, j]
    return acc


def _power(x: torch.Tensor, k: int) -> torch.Tensor:
    out = x
    for _ in range(k - 1):
        out = out * x
    return out


def _bincount(idx: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``np.bincount(idx, weights=w, minlength=n)`` in gather form: each
    bin sums its weights in the order they come.  A stable sort gives each
    weight its occurrence rank in its bin; a table (bin, rank) holds them,
    and its columns are added in rank order.  No atomics; one host wait
    (the largest rank)."""
    out = torch.zeros(n, dtype=w.dtype, device=w.device)
    if len(idx) == 0:
        return out
    si, order = torch.sort(idx, stable=True)
    # occurrence rank: position minus the first position of its value
    rank = torch.arange(len(si), device=si.device) - torch.searchsorted(si,
                                                                         si)
    table = torch.zeros((n, int(rank.max()) + 1), dtype=w.dtype,
                        device=w.device)
    table[si, rank] = w[order]
    for r in range(table.shape[1]):
        out = out + table[:, r]
    return out


def _groups(key: torch.Tensor, n: int):
    """Faces sorted by a group id in [0, n), each group in plan order:
    (order, the n + 1 group bounds as ints); one host wait."""
    ks, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(ks, torch.arange(n + 1, device=key.device))
    return order, bounds.tolist()


def estimate(forest: Forest, cell2dof, u, rho_q,
             rhs_points_ref: np.ndarray, rhs_weights: np.ndarray,
             degree: int = 1, use_volume_term: bool = True,
             plan: FacePlan = None) -> torch.Tensor:
    """Per-cell error indicator (float64, length n_cells) on the forest's
    device; ``u`` and ``rho_q`` may be numpy or tensors.

    ``plan``: a prebuilt/incrementally-updated FacePlan for this forest
    (adapt/estimator.py:update_face_plan); None rebuilds from scratch."""
    dim = forest.dim
    dev = forest.device
    n_q1 = degree + 1
    if plan is None:
        plan = build_face_plan(forest)
    grads, fweights, sub_grads = _face_grad_tables(dim, degree, n_q1)

    f64 = lambda a: (a.to(dev, torch.float64) if isinstance(a, torch.Tensor)
                     else upload(np.asarray(a), dev, torch.float64))
    c2d = (cell2dof.to(dev) if isinstance(cell2dof, torch.Tensor)
           else upload(np.asarray(cell2dof), dev))
    ucell = f64(u)[c2d]                            # (n_cells, nb)
    h = forest.h0 / (torch.ones_like(forest.level_t)
                     << forest.level_t).to(torch.float64)
    diam = h * math.sqrt(dim)
    n_cells = forest.n_cells
    cells, contrib = [], []

    def face_term(c1, c2, G1, G2, w, h1, h2):
        """diam-weighted face integral of the normal-gradient jump, added
        to both cells (reference grad / h)."""
        g1 = _products(ucell[c1], G1) / h1[:, None]
        g2 = _products(ucell[c2], G2) / h2[:, None]
        d = g1 - g2
        Jf = _products(d * d, np.asarray(w)[None, :])[:, 0] * _power(
            h1, dim - 1)
        cells.extend((c1, c2))
        contrib.extend((diam[c1] * Jf, diam[c2] * Jf))

    # ---- same-level faces (same h both sides), by axis
    order, bounds = _groups(plan.sl_axis, dim)
    for axis in range(dim):
        at = order[bounds[axis]:bounds[axis + 1]]
        if len(at) == 0:
            continue
        a, b = plan.sl_a[at], plan.sl_b[at]
        f_hi, f_lo = 2 * axis + 1, 2 * axis
        face_term(a, b, grads[f_hi][:, :, axis], grads[f_lo][:, :, axis],
                  fweights[f_hi], h[a], h[a])

    # ---- coarse-fine faces (integrate per fine subface), by (axis, fine
    # side, subface)
    n_sub = 2 ** (dim - 1)
    order, bounds = _groups((plan.cf_axis * 2 + plan.cf_side) * n_sub
                            + plan.cf_sub, 2 * dim * n_sub)
    for g in range(2 * dim * n_sub):
        at = order[bounds[g]:bounds[g + 1]]
        if len(at) == 0:
            continue
        f, sub = divmod(g, n_sub)          # f = 2 * axis + side
        fc, cc = plan.cf_fine[at], plan.cf_coarse[at]
        face_term(fc, cc, grads[f][:, :, f // 2],
                  sub_grads[(f, sub)][:, :, f // 2], fweights[f],
                  h[fc], h[cc])

    # Each cell's contributions in the order above: a cell meets each face
    # group at most once on each side, so these are numpy's per-group
    # bincounts added in turn, bit for bit.
    eta2 = (_bincount(torch.cat(cells), torch.cat(contrib), n_cells)
            if cells else torch.zeros(n_cells, dtype=torch.float64,
                                      device=dev))

    est2 = eta2
    if use_volume_term and rho_q is not None:
        # volume residual: (lap u_h + 4 pi rho~)^2; lap u_h == 0 for Q1 on
        # axis-aligned boxes, nonzero for higher degree
        with span("estimate.volume"):
            temp = (4.0 * np.pi) * f64(rho_q)
            if degree > 1:
                from coulomb_gmg_tpu_torch.ops.q1 import lap_basis_at
                lap = lap_basis_at(dim, degree, np.asarray(rhs_points_ref))
                temp = temp + _products(ucell, lap) / (h * h)[:, None]
            vol = _products(temp * temp,
                            np.asarray(rhs_weights)[None, :])[:, 0]
            vol = vol * _power(h, dim)
            est2 = est2 + (diam * diam) * vol

    return torch.sqrt(est2)


def mark_cells(error: torch.Tensor, fraction_of_max: float = 0.6):
    """Threshold marking (``GridRefinement::refine`` with 0.6*max,
    src/step-50.cc:1084-1089).  Returns (flags on the error's device,
    threshold)."""
    threshold = fraction_of_max * float(error.abs().max())
    return error > threshold, threshold
