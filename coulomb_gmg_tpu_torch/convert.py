"""State carried across from the JAX package.

The mesh, the solution and the atom state need no converter: they live in
numpy, and ``utils/checkpoint.py`` snapshots them (``Simulation`` resumes
from a snapshot the JAX driver wrote, via ``cfg.resume_from``).  The one
device-side state is the GMG operator set:

* :func:`operators_from_jax` takes the leaves of the JAX
  ``StencilGMG._fused_tree()`` as numpy arrays and returns the port's
  operator dict (solver/gmg.py) on a given device.  The layouts are the
  same transposed (K, n_pad) ELL tables and gather maps;
* :func:`gmg_from_jax` takes a JAX ``GMGPreconditioner``
  (solver/multigrid.py) as numpy leaves (:func:`gmg_leaves` reads them) and
  returns the port's, its smoothers rebuilt from the same level matrices.
"""

from __future__ import annotations

import numpy as np
import torch


def operators_from_jax(tree: dict, device) -> dict:
    """The port's operator set from a JAX fused tree with numpy leaves
    (e.g. ``jax.tree_util.tree_map(np.asarray, g._fused_tree())``)."""
    def put(a):
        a = np.array(a)               # a writable, contiguous copy
        t = torch.from_numpy(a).to(device)
        if a.dtype.kind in "iu":
            t = t.to(torch.int32)
        return t

    def ell(pair):
        return None if pair is None else (put(pair[0]), put(pair[1]))

    levels = []
    for lv in tree["levels"]:
        levels.append({
            "A": ell(lv["A"]), "inv_diag": put(lv["inv_diag"]),
            "theta": float(lv["theta"]), "delta": float(lv["delta"]),
            "if": ell(lv["if"]), "ifT": ell(lv["ifT"]),
            "P": ell(lv["P"]), "R": ell(lv["R"]),
            "l2g": put(lv["l2g"]), "cmask": put(lv["cmask"]),
        })
    sys = {k: put(v) for k, v in tree["sys"].items()}
    nb = sys["c2d"].shape[0]
    return {"sys": sys, "levels": levels,
            "src_lvl": put(tree["src_lvl"]), "src_idx": put(tree["src_idx"]),
            "dst": (tuple(put(a) for a in tree["dst"])
                    if tree["dst"] is not None else None),
            "dim": int(round(np.log2(nb)))}


def gmg_leaves(gmg) -> dict:
    """Numpy leaves of a ``GMGPreconditioner`` of either package: per level
    the CSR ``(indptr, indices, data, n_cols)`` of the matrix, interface
    and prolongation (None where absent), the copy maps and the coarse
    settings."""
    def csr(m):
        if m is None:
            return None
        data = m.data
        if hasattr(data, "detach"):
            data = data.detach().cpu()
        return (np.asarray(m.indptr), np.asarray(m.indices),
                np.array(data), int(m.n_cols))
    return {"matrices": [csr(m) for m in gmg.matrices],
            "interfaces": [csr(m) for m in gmg.interfaces],
            "prolongations": [csr(m) for m in gmg.prolongations],
            "copy_global": [np.asarray(a) for a in gmg.copy_global],
            "copy_level": [np.asarray(a) for a in gmg.copy_level],
            "n_dofs": int(gmg.n_dofs), "coarse_tol": float(gmg.coarse_tol),
            "coarse_maxiter": int(gmg.coarse_maxiter),
            "coarse_rtol": float(gmg.coarse_rtol)}


def gmg_from_jax(leaves: dict, device, smoother: str = "ssor",
                 smoother_damping: float = 0.5, smoother_steps: int = 2,
                 jacobi_damping: float = 0.6, colors=None):
    """The port's ``GMGPreconditioner`` on ``device`` from the numpy leaves
    of a JAX one (:func:`gmg_leaves`), so both packages apply the same
    operators.  Smoothers are rebuilt from the level matrices as
    ``build_gmg`` builds them (``colors``: per level, for "mc_ssor")."""
    from coulomb_gmg_tpu_torch.ops.smoothers import (
        MGSmoother, make_chebyshev, make_jacobi, make_mc_ssor, make_ssor)
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    from coulomb_gmg_tpu_torch.solver.multigrid import GMGPreconditioner

    def csr(leaf):
        if leaf is None:
            return None
        indptr, indices, data, n_cols = leaf
        return CSR.from_pattern(indptr, indices, np.array(data),
                                n_cols=n_cols, device=device)

    mats = [csr(m) for m in leaves["matrices"]]
    smoothers = [None]
    for l, A in enumerate(mats[1:], start=1):
        if smoother == "none":
            smoothers.append(None)
            continue
        if smoother == "ssor":
            pre = make_ssor(A, smoother_damping)
        elif smoother == "mc_ssor":
            pre = make_mc_ssor(A, colors[l], smoother_damping)
        elif smoother == "chebyshev":
            pre = make_chebyshev(A)
        else:
            pre = make_jacobi(A, jacobi_damping)
        smoothers.append(MGSmoother(A=A, precond=pre, steps=smoother_steps))
    return GMGPreconditioner(
        matrices=mats, interfaces=[csr(m) for m in leaves["interfaces"]],
        prolongations=[csr(m) for m in leaves["prolongations"]],
        smoothers=smoothers, copy_global=leaves["copy_global"],
        copy_level=leaves["copy_level"], n_dofs=leaves["n_dofs"],
        coarse_tol=leaves["coarse_tol"],
        coarse_maxiter=leaves["coarse_maxiter"],
        coarse_rtol=leaves["coarse_rtol"])
