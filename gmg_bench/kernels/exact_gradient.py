"""The gradient of the exact potential at the FE-error postprocess's
quadrature points (``ops/gradient.py:exact_gradient_cuda``), for points
``(P, 3)`` and atoms ``(A, 4)`` rows ``(x, y, z, q)``:

    grad(x) = sum_a W_a (x - X_a),
    W_a = q_a (2 r e^{-(r/r_c)^2} / (sqrt(pi) r_c) - erf(r/r_c)) / r^3.

Every (point, atom) pair is a term.  A pair at ``r < NEAR r_c`` costs the
full formula, 27 operations: 3 differences, r^2 (mul + 2 FMA), rsqrt, r^-3
(2 muls), q r^-3, 3 FMAs (the far form's 18), then r, r / r_c, its square,
exp, erf, the bracket (mul + FMA) and its product.  A pair farther out
costs the far form's 18: from ``NEAR`` on, the bracket's distance from -1,
``erfc(x) + 2 x e^{-x^2} / sqrt(pi)``, is below 2^-25, half a float32 unit
below 1, so the float32 bracket is -1 and ``W_a = -q_a / r^3``.  Bytes:
the points read and the gradient written (12 bytes a point each), the
atoms read (16 bytes an atom).

The program's own count (``coulomb_gmg_tpu_torch/roofline.py``) takes the
kernel's far test, ``r >= 4.5 r_c`` (raised by 1e-4), for ``NEAR``: the
pairs between 4.3527 and 4.5 r_c count 9 operations fewer here, about
0.03% of the bound at 8,000 atoms."""

from gmg_bench.metrics._roofline import bound_s as _bound, pairs_within

MODULE = "coulomb_gmg_tpu_torch.ops.gradient"
LAUNCHER = "exact_gradient_cuda"
DEVICE = ("exact_gradient_kernel",)
NEAR = 4.3527             # r / r_c from which the float32 bracket is -1
OPS_FAR = 18
OPS_NEAR = 27


def bound_s(args, kw) -> float:
    points, atoms, r_c = args
    n, a = points.shape[0], atoms.shape[0]
    near = pairs_within(points, atoms[:, :3], (NEAR * r_c) ** 2)
    ops = OPS_FAR * (n * a - near) + OPS_NEAR * near
    return _bound(ops, 24 * n + 16 * a)
