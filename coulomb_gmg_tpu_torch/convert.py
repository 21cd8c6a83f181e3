"""State carried across from the JAX package.

The mesh, the solution and the atom state need no converter: they live in
numpy, and ``utils/checkpoint.py`` snapshots them (``Simulation`` resumes
from a snapshot the JAX driver wrote, via ``cfg.resume_from``).  The one
device-side state is the GMG operator set:
:func:`operators_from_jax` takes the leaves of the JAX
``StencilGMG._fused_tree()`` as numpy arrays and returns the port's
operator dict (solver/gmg.py) on a given device.  The layouts are the same
transposed (K, n_pad) ELL tables and gather maps.
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
