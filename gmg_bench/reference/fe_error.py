"""Plain float64 reference of the FE-error postprocess
(``postprocess_error_in_energy_norm``, src/step-50.cc:1423-1461): the
energy-norm error

    e = sqrt( sum_c int_c |grad u_h - grad phi|^2 dx )

of a solution ``u_h`` given at the vertices of a Q1 mesh
(gmg_bench/reference/fem.py), with the Laplace rule (two Gauss points an
axis, the rule of the reference's ``QGauss<dim>(degree + 1)``) and the
gradient of the exact potential of Gaussian charges summed over every atom:

    grad phi(x) = sum_a W_a (x - X_a),
    W_a = q_a (2 r e^{-(r/r_c)^2} / (sqrt(pi) r_c) - erf(r/r_c)) / r^3,

``r = |x - X_a|``, with ``W_a = 0`` where ``r^2 < 1e-14`` (the removable
singularity at an atom).

How the 64,000-atom sum is afforded.  Beyond ``FAR r_c`` from a point the
bracket ``2 x e^{-x^2} / sqrt(pi) - erf(x)`` differs from -1 by
``erfc(x) + 2 x e^{-x^2} / sqrt(pi) < 1e-17``, under half a float64 unit
of 1, so ``W_a = -q_a / r^3`` there to rounding: the formula itself, not a
cut.  The points are sorted into compact blocks (Morton order), and for
each block every atom takes the far form in two matrix products: ``r^2 =
|x - c|^2 + |X - c|^2 - 2 (x - c).(X - c)`` about the block's centre ``c``
(one product over five columns), its reciprocal square root cubed, and
``sum_a W_a (x - X_a)`` as ``W [q (X - c), q]`` (a second product).  For
every ``NEAR_STEP`` neighbouring points of the block, the atoms within
``FAR r_c`` of their box (and a margin) have their far term zeroed in that
matrix before the second product, and take the whole formula from direct
differences ``x - X_a`` instead, so every near pair is exact whatever the
first product rounded.  Below float64 the first product's ``|X - c|^2`` keeps
too few digits for the distance (bfloat16 rounds 100 to a step of 0.5),
so there every pair takes the whole formula from direct differences.

Departures from src/step-50.cc: the solution is read at the mesh's
vertices (hanging ones as given, the program's distributed values); the
exact gradient is this closed form, not deal.II's ``Function::gradient``
of the analytic solution; the cells' integrals are summed in float64 in
one order, not per MPI rank.  ``dtype`` runs the pair work in another
precision: the control (gmg_bench/control_fe.py) takes bfloat16.
"""

from __future__ import annotations

import math

import torch

from gmg_bench.reference.fem import CORNERS, GAUSS2, Mesh

FAR = 6.5                 # r / r_c from which the float64 bracket is -1
MARGIN = 1.0e-3           # relative widening of the near test, for rounding
PAIRS = {"cpu": 1 << 21, "cuda": 1 << 30}   # (point, atom) pairs a block
NEAR_STEP = 1024          # points a near test, in Morton order


def gradient_table() -> tuple:
    """(points (8, 3), weights (8,), reference gradients (8 points, 8
    corners, 3)) of the Q1 cube at the 2 x 2 x 2 Gauss rule, float64."""
    g = torch.tensor(GAUSS2, dtype=torch.float64)
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    c = CORNERS.to(torch.float64)
    f = torch.where(c[None] == 1, pts[:, None, :], 1.0 - pts[:, None, :])
    grad = torch.empty(8, 8, 3, dtype=torch.float64)
    for d in range(3):
        others = [e for e in range(3) if e != d]
        grad[..., d] = (2.0 * c[None, :, d] - 1.0) * f[..., others].prod(-1)
    return pts, torch.full((8,), 0.125, dtype=torch.float64), grad


def morton_order(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """The permutation that lists ``points`` (n, 3) in Morton (Z) order of
    a ``2^bits`` grid over their bounding box."""
    lo = points.amin(0)
    span = (points.amax(0) - lo).clamp(min=1e-30)
    g = ((points - lo) / span * ((1 << bits) - 1)).round().to(torch.int64)
    key = torch.zeros(points.shape[0], dtype=torch.int64,
                      device=points.device)
    for b in range(bits):
        for d in range(3):
            key |= ((g[:, d] >> b) & 1) << (3 * b + d)
    return torch.argsort(key)


def _whole(x: torch.Tensor, X: torch.Tensor, q: torch.Tensor, r_c: float,
           dtype) -> tuple:
    """(``W`` (b, k), ``x - X`` (b, k, 3)) of the whole formula for the
    points ``x`` (b, 3) and atoms ``X`` (k, 3), ``q`` (k,), the differences
    taken in float64 and the rest in ``dtype``."""
    d = (x[:, None, :] - X[None]).to(dtype)
    r2 = (d * d).sum(-1)
    at = r2 < 1e-14
    ir = torch.rsqrt(torch.where(at, torch.ones_like(r2), r2))
    r = r2 * ir
    rq = r / r_c
    c2 = 2.0 / (math.sqrt(math.pi) * r_c)
    w = q.to(dtype) * (c2 * r * torch.exp(-rq * rq)
                       - torch.special.erf(rq)) * ir * ir * ir
    return torch.where(at, torch.zeros_like(w), w), d


def exact_gradient(points: torch.Tensor, pos: torch.Tensor, q: torch.Tensor,
                   r_c: float, dtype=torch.float64) -> torch.Tensor:
    """(n, 3) float64 gradient of the exact potential at ``points`` (n, 3)
    over every atom ``pos`` (A, 3), ``q`` (A,); the pair work in
    ``dtype``."""
    dev = points.device
    n, A = points.shape[0], pos.shape[0]
    out = torch.zeros(n, 3, dtype=torch.float64, device=dev)
    if n == 0 or A == 0:
        return out
    order = morton_order(points)
    P = points[order].to(torch.float64)
    X = pos.to(dev, torch.float64)
    Q = q.to(dev, torch.float64)
    if dtype != torch.float64:
        step = max(1, PAIRS[dev.type] // (8 * A))
        for s in range(0, n, step):
            w, d = _whole(P[s:s + step], X, Q, r_c, dtype)
            out[order[s:s + step]] = (w[..., None] * d).sum(1).to(
                torch.float64)
        return out
    reach2 = (FAR * r_c * (1.0 + MARGIN)) ** 2
    step = max(NEAR_STEP, PAIRS[dev.type] // A)
    for s in range(0, n, step):
        x = P[s:s + step]
        c = 0.5 * (x.amin(0) + x.amax(0))
        xa, Xa = x - c, X - c
        # far form: r^2 by one product, r^-3 as its reciprocal square root
        # cubed, then the sum by a second product
        lhs = torch.cat([xa, (xa * xa).sum(-1, keepdim=True),
                         torch.ones_like(xa[:, :1])], 1)
        rhs = torch.cat([-2.0 * Xa, torch.ones_like(Xa[:, :1]),
                         (Xa * Xa).sum(-1, keepdim=True)], 1)
        far = (lhs @ rhs.T).rsqrt_().pow_(3)        # r^-3, (b, A)
        # the atoms near each NEAR_STEP neighbouring points (within FAR
        # r_c of their box, and a margin) leave the far form for the
        # whole formula
        nears = []
        for t in range(0, x.shape[0], NEAR_STEP):
            xs = x[t:t + NEAR_STEP]
            gap = torch.clamp(torch.maximum(xs.amin(0) - X, X - xs.amax(0)),
                              min=0.0)
            near = torch.nonzero((gap * gap).sum(-1) < reach2).squeeze(1)
            far[t:t + NEAR_STEP, near] = 0.0
            nears.append((t, near))
        m = far @ torch.cat([Q[:, None] * Xa, Q[:, None]], 1)
        del far
        g = m[:, :3] - xa * m[:, 3:]                # sum -q r^-3 (x - X)
        for t, near in nears:
            w, d = _whole(x[t:t + NEAR_STEP], X[near], Q[near], r_c, dtype)
            g[t:t + NEAR_STEP] += (w[..., None] * d).sum(1)
        out[order[s:s + step]] = g
    return out


def energy_norm_error(mesh: Mesh, u: torch.Tensor, pos, q, r_c: float,
                      dtype=torch.float64) -> float:
    """``e`` of the vertex values ``u`` (V,) on ``mesh`` for atoms ``pos``
    (A, 3), ``q`` (A,); the exact gradient's pair work in ``dtype``, the
    rest in float64."""
    dev = mesh.device
    pts, w, grad = (t.to(dev) for t in gradient_table())
    pos = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    h = mesh.h
    grad_h = torch.einsum("cb,qbd->cqd", u.to(dev, torch.float64)[
        mesh.cell2v], grad) / h[:, None, None]
    x = mesh.cell_lower[:, None, :] + h[:, None, None] * pts[None]
    grad_h -= exact_gradient(x.reshape(-1, 3), pos, q, r_c, dtype).reshape(
        x.shape)
    return float(torch.sqrt((((grad_h ** 2).sum(-1) @ w) * h ** 3).sum()))
