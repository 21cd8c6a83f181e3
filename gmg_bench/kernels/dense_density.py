"""The all-atom density at the load's quadrature points
(``ops/density.py:dense_density_cuda``, the branch of ``flag_rhs_assembly``
false): for cells ``lower (C, 3)``, ``h (C,)``, reference points ``pref
(n_q, 3)`` and atoms ``(A, 4)`` rows ``(x, y, z, q)``, each point ``lower +
h pref`` sums ``q_a exp(-|x - X_a|^2 / r_c^2)`` over every atom.

A term is a (point, atom) pair whose float32 value is not zero: ``t =
|x - X_a|^2 / r_c^2`` below ``ZERO_T = 150 ln 2``, where ``exp(-t)``
falls to half the smallest float32 subnormal and rounds to +0; a zero
term leaves the float32 sum unchanged, whatever a kernel does with it.  A
term costs 12 operations (3 differences, r^2 (mul + 2 FMA), scale, exp,
FMA).  ``t`` is taken in float64 from the float32 operands.  Bytes: the
cells' corners and sizes, the reference points and the atoms read once,
the ``(n_out, n_q)`` float32 output written, its padding rows with it.
The kernel's own skip of far atom groups is not counted: it skips some of
the zero terms, never one that is not."""

import math

from gmg_bench.metrics._roofline import (OPS_DENSITY, bound_s as _bound,
                                         pairs_within)

MODULE = "coulomb_gmg_tpu_torch.ops.density"
LAUNCHER = "dense_density_cuda"
DEVICE = ("dense_density_kernel", "group_boxes_kernel")
ZERO_T = 150.0 * math.log(2.0)


def bound_s(args, kw) -> float:
    lower, h, pref, atoms = args
    C, n_q, A = lower.shape[0], pref.shape[0], atoms.shape[0]
    points = (lower.double()[:, None, :]
              + h.double()[:, None, None] * pref.double()).reshape(-1, 3)
    terms = pairs_within(points, atoms[:, :3], ZERO_T / kw["inv_rc2"])
    n_bytes = 4 * (4 * C + 3 * n_q + 4 * A + kw["n_out"] * n_q)
    return _bound(OPS_DENSITY * terms, n_bytes)
