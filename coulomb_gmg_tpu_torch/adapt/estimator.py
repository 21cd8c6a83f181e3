"""Kelly face-jump error estimator and threshold marking, in float64.

Counterpart of coulomb_gmg_tpu/adapt/estimator.py (the reference's
``estimate_error_and_mark_cells``, src/step-50.cc:1020-1090).  That module
imports jax at the top, so its numpy code is carried here unchanged: the
face plan is built once and updated incrementally across refinements, and
the jump integrals and the optional volume term are float64 numpy.  Marking
is threshold-sensitive (0.6 * max), which is why it stays in float64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from coulomb_gmg_tpu.mesh.forest import Forest, KeyIndex, corner_offsets
from coulomb_gmg_tpu.ops.q1 import face_tables, gauss_rule, _basis_at


@dataclass
class FacePlan:
    """Precomputed interior-face groups for one mesh topology."""

    # same-level faces: cells (m,), neighbor (m,), axis (m,)
    sl_a: np.ndarray
    sl_b: np.ndarray
    sl_axis: np.ndarray
    # coarse-fine faces: fine cell, coarse cell, axis, fine side (0: fine
    # face at low side), subface config id in [0, 2^(dim-1))
    cf_fine: np.ndarray
    cf_coarse: np.ndarray
    cf_axis: np.ndarray
    cf_side: np.ndarray
    cf_sub: np.ndarray


def build_face_plan(forest: Forest) -> FacePlan:
    dim = forest.dim
    lvl = forest.level.astype(np.int64)
    per_level = {}
    for l in range(forest.n_levels):
        sel = np.where(lvl == l)[0]
        keys = forest.level_cell_key(l, forest.ijk[sel])
        order = np.argsort(keys)
        per_level[l] = (KeyIndex(keys), sel[order])

    sl_a, sl_b, sl_axis = [], [], []
    cf_fine, cf_coarse, cf_axis, cf_side, cf_sub = [], [], [], [], []

    for l in range(forest.n_levels):
        cells = np.where(lvl == l)[0]
        if len(cells) == 0:
            continue
        ijk = forest.ijk[cells]
        side_n = forest.side(l)
        ki, act = per_level[l]
        for axis in range(dim):
            # same-level faces, + direction only (each counted once)
            nb = ijk.copy()
            nb[:, axis] += 1
            inside = nb[:, axis] < side_n
            pos = ki.lookup(forest.level_cell_key(l, nb))
            hit = inside & (pos >= 0)
            sl_a.append(cells[hit])
            sl_b.append(act[pos[hit]])
            sl_axis.append(np.full(hit.sum(), axis, dtype=np.int64))
            if l == 0:
                continue
            # coarse neighbors across +/- faces
            kc, actc = per_level[l - 1]
            for sgn, sidev in ((1, 1), (-1, 0)):
                nb = ijk.copy()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side_n)
                parent = nb // 2
                posc = kc.lookup(forest.level_cell_key(l - 1, parent))
                # only when the same-level neighbor does NOT exist
                pos_same = ki.lookup(forest.level_cell_key(l, nb))
                hit = inside & (pos_same < 0) & (posc >= 0)
                if not hit.any():
                    continue
                sub = np.zeros(hit.sum(), dtype=np.int64)
                free = [d for d in range(dim) if d != axis]
                for k, d in enumerate(free):
                    sub |= (ijk[hit][:, d] & 1) << k
                cf_fine.append(cells[hit])
                cf_coarse.append(actc[posc[hit]])
                cf_axis.append(np.full(hit.sum(), axis, dtype=np.int64))
                cf_side.append(np.full(hit.sum(), sidev, dtype=np.int64))
                cf_sub.append(sub)

    cat = lambda xs: (np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return FacePlan(sl_a=cat(sl_a), sl_b=cat(sl_b), sl_axis=cat(sl_axis),
                    cf_fine=cat(cf_fine), cf_coarse=cat(cf_coarse),
                    cf_axis=cat(cf_axis), cf_side=cat(cf_side),
                    cf_sub=cat(cf_sub))


def update_face_plan(old: Forest, new: Forest, old_plan: FacePlan,
                     omap: np.ndarray) -> FacePlan:
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
    (plus per-level key sorts for the levels new cells touch); the
    reference pays this cost inside KellyErrorEstimator on every cycle
    (src/step-50.cc:1020-1090)."""
    dim = new.dim
    omap = np.asarray(omap)
    survived_new = new.level == old.level[omap]          # per NEW cell
    new_of_old = np.full(old.n_cells, -1, dtype=np.int64)
    surv_idx = np.where(survived_new)[0]
    new_of_old[omap[surv_idx]] = surv_idx
    old_survived = new_of_old >= 0                       # per OLD cell

    # ---- keep remapped faces between surviving cells
    keep_sl = old_survived[old_plan.sl_a] & old_survived[old_plan.sl_b]
    sl_a = [new_of_old[old_plan.sl_a[keep_sl]]]
    sl_b = [new_of_old[old_plan.sl_b[keep_sl]]]
    sl_axis = [old_plan.sl_axis[keep_sl]]
    keep_cf = (old_survived[old_plan.cf_fine]
               & old_survived[old_plan.cf_coarse])
    cf_fine = [new_of_old[old_plan.cf_fine[keep_cf]]]
    cf_coarse = [new_of_old[old_plan.cf_coarse[keep_cf]]]
    cf_axis = [old_plan.cf_axis[keep_cf]]
    cf_side = [old_plan.cf_side[keep_cf]]
    cf_sub = [old_plan.cf_sub[keep_cf]]

    # ---- per-level key indexes of the NEW forest, built lazily
    lvl = new.level.astype(np.int64)
    per_level = {}

    def ki_of(l):
        if l not in per_level:
            if l < 0 or l >= new.n_levels:
                per_level[l] = None
            else:
                sel = np.where(lvl == l)[0]
                keys = new.level_cell_key(l, new.ijk[sel])
                order = np.argsort(keys)
                per_level[l] = (KeyIndex(keys), sel[order])
        return per_level[l]

    is_new = ~survived_new
    new_cells = np.where(is_new)[0]
    for l in np.unique(lvl[new_cells]) if len(new_cells) else []:
        cells = new_cells[lvl[new_cells] == l]
        ijk = new.ijk[cells]
        side_n = new.side(l)
        ki_l = ki_of(l)
        for axis in range(dim):
            free = [d for d in range(dim) if d != axis]
            for sgn in (1, -1):
                nb = ijk.copy()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side_n)
                ki, act = ki_l
                pos = ki.lookup(new.level_cell_key(l, nb))
                pos = np.where(inside, pos, -1)
                same = pos >= 0
                if same.any():
                    other = act[pos[same]]
                    o_new = is_new[other]
                    # new-new: + direction only; new-surviving: always.
                    # Orientation: sl_a is the cell on the LOW side of the
                    # face (the full builder scans + direction only).
                    add = (~o_new) | (sgn == 1)
                    here = cells[same][add]
                    there = other[add]
                    a = here if sgn == 1 else there
                    b = there if sgn == 1 else here
                    sl_a.append(a)
                    sl_b.append(b)
                    sl_axis.append(np.full(len(a), axis, dtype=np.int64))
                # coarse neighbor (fine side = this new cell)
                rem = inside & ~same
                if rem.any() and l > 0 and ki_of(l - 1) is not None:
                    kc, actc = ki_of(l - 1)
                    parent = nb[rem] // 2
                    posc = kc.lookup(new.level_cell_key(l - 1, parent))
                    hit = posc >= 0
                    if hit.any():
                        fc = cells[rem][hit]
                        sub = np.zeros(hit.sum(), dtype=np.int64)
                        fijk = new.ijk[fc]
                        for k, d in enumerate(free):
                            sub |= (fijk[:, d] & 1) << k
                        cf_fine.append(fc)
                        cf_coarse.append(actc[posc[hit]])
                        cf_axis.append(np.full(hit.sum(), axis,
                                               dtype=np.int64))
                        cf_side.append(np.full(hit.sum(),
                                               1 if sgn == 1 else 0,
                                               dtype=np.int64))
                        cf_sub.append(sub)
                    rem2 = np.where(rem)[0][~hit]
                else:
                    rem2 = np.where(rem)[0]
                # finer neighbors (coarse side = this new cell); add only
                # SURVIVING fine subcells — new fine cells add the face
                # from their own scan
                if len(rem2) and ki_of(l + 1) is not None:
                    kf, actf = ki_of(l + 1)
                    nbr = nb[rem2]
                    base = nbr * 2
                    # subcells on the face adjacent to this cell: axis
                    # coordinate pinned to the NEAR side of the neighbor
                    base[:, axis] = (2 * nbr[:, axis]
                                     + (0 if sgn == 1 else 1))
                    for subcfg in range(2 ** (dim - 1)):
                        sub_ijk = base.copy()
                        for k, d in enumerate(free):
                            sub_ijk[:, d] += (subcfg >> k) & 1
                        posf = kf.lookup(new.level_cell_key(l + 1, sub_ijk))
                        hitf = posf >= 0
                        if not hitf.any():
                            continue
                        f = actf[posf[hitf]]
                        sels = ~is_new[f]
                        if not sels.any():
                            continue
                        f = f[sels]
                        cc = cells[rem2][hitf][sels]
                        fijk = new.ijk[f]
                        sub = np.zeros(len(f), dtype=np.int64)
                        for k, d in enumerate(free):
                            sub |= (fijk[:, d] & 1) << k
                        cf_fine.append(f)
                        cf_coarse.append(cc)
                        cf_axis.append(np.full(len(f), axis,
                                               dtype=np.int64))
                        # the fine cell sees its coarse neighbor in the
                        # -sgn direction
                        cf_side.append(np.full(len(f),
                                               1 if sgn == -1 else 0,
                                               dtype=np.int64))
                        cf_sub.append(sub)

    cat = lambda xs: (np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return FacePlan(sl_a=cat(sl_a), sl_b=cat(sl_b), sl_axis=cat(sl_axis),
                    cf_fine=cat(cf_fine), cf_coarse=cat(cf_coarse),
                    cf_axis=cat(cf_axis), cf_side=cat(cf_side),
                    cf_sub=cat(cf_sub))


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


def estimate(forest: Forest, cell2dof: np.ndarray, u, rho_q,
             rhs_points_ref: np.ndarray, rhs_weights: np.ndarray,
             degree: int = 1, use_volume_term: bool = True,
             plan: FacePlan = None) -> np.ndarray:
    """Per-cell error indicator (numpy float64, length n_cells).

    ``plan``: a prebuilt/incrementally-updated FacePlan for this forest
    (adapt/estimator.py:update_face_plan); None rebuilds from scratch."""
    dim = forest.dim
    n_q1 = degree + 1
    if plan is None:
        plan = build_face_plan(forest)
    grads, fweights, sub_grads = _face_grad_tables(dim, degree, n_q1)

    # host numpy throughout: per-cycle shapes are fresh every adaptive
    # cycle, so eager XLA would recompile each primitive per cycle.
    u = np.asarray(u, np.float64)
    ucell = u[cell2dof]                            # (n_cells, nb)
    h = forest.cell_h()
    diam = h * np.sqrt(dim)
    n_cells = forest.n_cells
    eta2 = np.zeros(n_cells)

    # ---- same-level faces
    if len(plan.sl_a):
        for axis in range(dim):
            sel = plan.sl_axis == axis
            if not sel.any():
                continue
            a, b = plan.sl_a[sel], plan.sl_b[sel]
            f_hi, f_lo = 2 * axis + 1, 2 * axis
            Ga = np.asarray(grads[f_hi][:, :, axis])  # (n_fq, nb)
            Gb = np.asarray(grads[f_lo][:, :, axis])
            w = np.asarray(fweights[f_hi])
            ha = h[a]
            # normal gradients (reference grad / h); same h both sides
            ga = (ucell[a] @ Ga.T) / ha[:, None]
            gb = (ucell[b] @ Gb.T) / ha[:, None]
            jump2 = ((ga - gb) ** 2) @ w
            Jf = jump2 * ha ** (dim - 1)           # face integral
            eta2 += np.bincount(a, weights=diam[a] * Jf, minlength=n_cells)
            eta2 += np.bincount(b, weights=diam[b] * Jf, minlength=n_cells)

    # ---- coarse-fine faces (integrate per fine subface)
    if len(plan.cf_fine):
        for axis in range(dim):
            for sidev in (0, 1):
                for sub in range(2 ** (dim - 1)):
                    sel = ((plan.cf_axis == axis) & (plan.cf_side == sidev)
                           & (plan.cf_sub == sub))
                    if not sel.any():
                        continue
                    fc = plan.cf_fine[sel]
                    cc = plan.cf_coarse[sel]
                    f = 2 * axis + sidev
                    Gf = np.asarray(grads[f][:, :, axis])
                    Gc = np.asarray(sub_grads[(f, sub)][:, :, axis])
                    w = np.asarray(fweights[f])
                    hf = h[fc]
                    hc = h[cc]
                    gf = (ucell[fc] @ Gf.T) / hf[:, None]
                    gc = (ucell[cc] @ Gc.T) / hc[:, None]
                    jump2 = ((gf - gc) ** 2) @ w
                    Jf = jump2 * hf ** (dim - 1)
                    eta2 += np.bincount(fc, weights=diam[fc] * Jf,
                                        minlength=n_cells)
                    eta2 += np.bincount(cc, weights=diam[cc] * Jf,
                                        minlength=n_cells)

    est2 = eta2
    if use_volume_term and rho_q is not None:
        # volume residual: (lap u_h + 4 pi rho~)^2; lap u_h == 0 for Q1 on
        # axis-aligned boxes, nonzero for higher degree
        temp = 4.0 * np.pi * np.asarray(rho_q, np.float64)
        if degree > 1:
            from coulomb_gmg_tpu.ops.q1 import lap_basis_at
            lap = lap_basis_at(dim, degree, np.asarray(rhs_points_ref))
            temp = temp + (ucell @ lap.T) / (h ** 2)[:, None]
        vol = (temp ** 2) @ np.asarray(rhs_weights)
        vol = vol * h ** dim
        est2 = est2 + diam ** 2 * vol

    return np.sqrt(est2)


def mark_cells(error: np.ndarray, fraction_of_max: float = 0.6):
    """Threshold marking (``GridRefinement::refine`` with 0.6*max,
    src/step-50.cc:1084-1089).  Returns (flags, threshold)."""
    threshold = fraction_of_max * float(np.max(np.abs(error)))
    return error > threshold, threshold
