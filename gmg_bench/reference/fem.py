"""Plain float64 reference of the adaptive Q1 problem that a cell solves.

Worked out again from the configuration, the atoms and the active cells of
the mesh alone, with nothing taken from the program under test:

* the base grid of the published study (``base_grid``): ``subdivided
  hyper rectangle`` of the box with its vacuum margin;
* the Q1 space of an octree mesh (:class:`Mesh`): every cell corner is a
  vertex; a vertex in the interior of a face or an edge of a coarser
  active cell hangs on that face's four or that edge's two corners, chains
  resolved until every master is a vertex that does not hang; a boundary
  vertex that does not hang is Dirichlet;
* the stiffness of a cube of side ``h`` (``h`` times the unit cube's, two
  Gauss points per axis), applied cell by cell;
* the load ``F_i = int rho phi_i`` from the density at the two-point Gauss
  points (gmg_bench/reference/density.py);
* the Dirichlet values: the dipole far field ``p . x / |x|^3`` with
  ``p = sum q_a X_a`` (the configuration's "Inhomogeneous" boundary).

:func:`residual` judges a solution, given as values at vertex positions,
by the relative residual of the condensed Galerkin system,
``|C^T (F - K u)|_free / |C^T (F - K u_g)|_free``, ``u_g`` the field that
is zero on the free vertices.  :func:`control_solution` is the same
reference put in the program's place: the system assembled and solved by
Jacobi-CG in a given (lower) precision.
"""

from __future__ import annotations

import math

import torch

from gmg_bench.reference.density import density_at, member_table

DIM = 3
# corner b of a cell sits at offset ((b >> 0) & 1, (b >> 1) & 1, (b >> 2) & 1)
CORNERS = torch.tensor([[(b >> d) & 1 for d in range(DIM)] for b in range(8)],
                       dtype=torch.int64)
GAUSS2 = (0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0))


def base_grid(cfg: dict):
    """(cells per axis, lower corner, cell size) of the level-0 grid: the
    box ``[domain_left, domain_right]^3`` in cells of ``2 h`` widened by
    ``vacuum_repetitions`` of them on each side, each split in two."""
    a = 2.0 * cfg["mesh_size_h"]
    n = (cfg["domain_right"] - cfg["domain_left"]) / a
    reps = int(round(2 * (n + 2 * cfg["vacuum_repetitions"])))
    lower = cfg["domain_left"] - cfg["vacuum_repetitions"] * a
    return reps, lower, float(cfg["mesh_size_h"])


def _patterns():
    """The 18 points of a cell's faces and edges on which a finer
    neighbour's vertex hangs: offsets in half cells (18, 3), the corners it
    hangs on (18, 4) and their weights (18, 4; an edge's last two zero)."""
    offs, masters, weights = [], [], []
    for d in range(DIM):
        for t in (0, 1):
            o = [1, 1, 1]
            o[d] = 2 * t
            offs.append(o)
            masters.append([b for b in range(8) if (b >> d) & 1 == t])
            weights.append([0.25] * 4)
    for d in range(DIM):
        e1, e2 = [e for e in range(DIM) if e != d]
        for t1 in (0, 1):
            for t2 in (0, 1):
                o = [0, 0, 0]
                o[d], o[e1], o[e2] = 1, 2 * t1, 2 * t2
                offs.append(o)
                cs = [b for b in range(8)
                      if (b >> e1) & 1 == t1 and (b >> e2) & 1 == t2]
                masters.append(cs + cs)
                weights.append([0.5, 0.5, 0.0, 0.0])
    return (torch.tensor(offs), torch.tensor(masters),
            torch.tensor(weights, dtype=torch.float64))


def _unit_tables():
    """Unit-cube Q1 tables in float64: the stiffness (8, 8) and
    ``w_q phi_b(xi_q)`` (8 points, 8 corners) with the points (8, 3)."""
    g = torch.tensor(GAUSS2, dtype=torch.float64)
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    w = torch.full((8,), 0.125, dtype=torch.float64)
    c = CORNERS.to(torch.float64)
    f = torch.where(c[None] == 1, pts[:, None, :], 1.0 - pts[:, None, :])
    phi = f.prod(-1)                                     # (q, b)
    sgn = 2.0 * c - 1.0                                  # d/dx of x or 1-x
    grad = torch.empty(8, 8, DIM, dtype=torch.float64)
    for d in range(DIM):
        others = [e for e in range(DIM) if e != d]
        grad[..., d] = sgn[None, :, d] * f[..., others].prod(-1)
    kref = torch.einsum("q,qad,qbd->ab", w, grad, grad)
    return kref, w[:, None] * phi, pts


KREF, WPHI, QPTS = _unit_tables()


class Mesh:
    """The Q1 space of the active cells ``(level, ijk)`` of an octree over
    the base grid ``(reps, lower, h0)``; tensors on ``device``."""

    def __init__(self, reps: int, lower: float, h0: float, level, ijk,
                 device="cpu"):
        dev = torch.device(device)
        self.device = dev
        self.reps, self.h0 = reps, h0
        self.level = torch.as_tensor(level, device=dev).to(torch.int64)
        self.ijk = torch.as_tensor(ijk, device=dev).to(torch.int64)
        self.L = int(self.level.max()) if self.level.numel() else 0
        self.S = reps << self.L                  # finest cells per axis
        self.hn = h0 / (1 << self.L)             # finest cell size
        self.lower = float(lower)
        C = self.level.numel()
        self.scale = torch.ones_like(self.level) << (self.L - self.level)
        corners = ((self.ijk[:, None, :] + CORNERS.to(dev)[None])
                   * self.scale[:, None, None])
        self.vkeys, inv = torch.unique(self.key(corners), return_inverse=True)
        self.cell2v = inv.reshape(C, 8)
        self.h = h0 * torch.pow(2.0, -self.level.to(torch.float64))
        self.cell_lower = self.lower + self.h[:, None] * self.ijk.to(
            torch.float64)
        self._constraints()

    @property
    def n_cells(self) -> int:
        return self.level.numel()

    @property
    def n_vertices(self) -> int:
        return self.vkeys.numel()

    def key(self, coords: torch.Tensor) -> torch.Tensor:
        m = self.S + 1
        return (coords[..., 0] * m + coords[..., 1]) * m + coords[..., 2]

    def coords(self, keys: torch.Tensor) -> torch.Tensor:
        m = self.S + 1
        return torch.stack([keys // (m * m), (keys // m) % m, keys % m], -1)

    def positions(self) -> torch.Tensor:
        """(V, 3) float64 vertex positions."""
        return self.lower + self.hn * self.coords(self.vkeys).to(torch.float64)

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """Vertex ids of ``keys``, -1 where no vertex has the key."""
        pos = torch.searchsorted(self.vkeys, keys).clamp(
            max=self.n_vertices - 1)
        return torch.where(self.vkeys[pos] == keys, pos, -1)

    def _constraints(self):
        dev = self.device
        offs, masters, wts = (t.to(dev) for t in _patterns())
        big = torch.nonzero(self.scale >= 2).squeeze(1)
        rows, cols, ws = [], [], []
        for s in range(0, big.numel(), 1 << 18):
            c = big[s:s + (1 << 18)]
            sc = self.scale[c]
            pts = (self.ijk[c, None, :] * sc[:, None, None]
                   + offs[None] * (sc[:, None, None] // 2))
            vid = self.lookup(self.key(pts))               # (c, 18)
            hit = torch.nonzero(vid >= 0)
            cc, pp = c[hit[:, 0]], hit[:, 1]
            rows.append(vid[hit[:, 0], pp])
            cols.append(self.cell2v[cc[:, None], masters[pp]])
            ws.append(wts[pp])
        V = self.n_vertices
        if rows:
            r, c, w = torch.cat(rows), torch.cat(cols), torch.cat(ws)
            order = torch.argsort(r, stable=True)
            r, c, w = r[order], c[order], w[order]
            first = torch.ones_like(r, dtype=torch.bool)
            first[1:] = r[1:] != r[:-1]
            r, c, w = r[first], c[first], w[first]
        else:
            r = torch.zeros(0, dtype=torch.int64, device=dev)
            c = torch.zeros(0, 4, dtype=torch.int64, device=dev)
            w = torch.zeros(0, 4, dtype=torch.float64, device=dev)
        self.hanging = torch.zeros(V, dtype=torch.bool, device=dev)
        self.hanging[r] = True
        co = self.coords(self.vkeys)
        on_boundary = ((co == 0) | (co == self.S)).any(-1)
        self.dirichlet = on_boundary & ~self.hanging
        self.free = ~on_boundary & ~self.hanging
        # resolve chains: a master that hangs is replaced by its masters
        slot = torch.full((V,), -1, dtype=torch.int64, device=dev)
        slot[r] = torch.arange(r.numel(), device=dev)
        rr = r.repeat_interleave(4)
        cc, ww = c.reshape(-1), w.reshape(-1)
        keep = ww != 0
        rr, cc, ww = rr[keep], cc[keep], ww[keep]
        for _ in range(64):
            hh = self.hanging[cc]
            if not bool(hh.any()):
                break
            sl = slot[cc[hh]]
            r2 = rr[hh].repeat_interleave(4)
            c2 = c[sl].reshape(-1)
            w2 = (ww[hh][:, None] * w[sl]).reshape(-1)
            k2 = w2 != 0
            rr = torch.cat([rr[~hh], r2[k2]])
            cc = torch.cat([cc[~hh], c2[k2]])
            ww = torch.cat([ww[~hh], w2[k2]])
        else:
            raise RuntimeError("hanging-vertex chains did not resolve")
        self.c_rows, self.c_cols, self.c_w = rr, cc, ww

    # ------------------------------------------------------------- algebra

    def distribute(self, u: torch.Tensor) -> torch.Tensor:
        """``u`` with every hanging vertex set from its (resolved) masters."""
        out = u.clone()
        out[self.hanging] = 0
        return out.index_add_(0, self.c_rows,
                              self.c_w.to(u.dtype) * u[self.c_cols])

    def condense(self, r: torch.Tensor) -> torch.Tensor:
        """``C^T r`` on the free vertices."""
        out = r.clone().index_add_(0, self.c_cols,
                                   self.c_w.to(r.dtype) * r[self.c_rows])
        return out[self.free]

    def apply_k(self, u: torch.Tensor) -> torch.Tensor:
        """The unconstrained stiffness times ``u``, cell by cell."""
        ul = u[self.cell2v]
        yl = (ul @ KREF.to(self.device, u.dtype)) * self.h.to(u.dtype)[:, None]
        return torch.zeros_like(u).index_add_(0, self.cell2v.reshape(-1),
                                              yl.reshape(-1))

    def quad_points(self) -> torch.Tensor:
        """(C, 8, 3) float64 Gauss points of the load."""
        return (self.cell_lower[:, None, :]
                + self.h[:, None, None] * QPTS.to(self.device)[None])

    def load(self, rho: torch.Tensor) -> torch.Tensor:
        """``F_i = sum_cells h^3 sum_q w_q phi_i(x_q) rho(x_q)`` from the
        (C, 8) density, in its dtype."""
        fl = (rho @ WPHI.to(self.device, rho.dtype)) * (
            self.h.to(rho.dtype) ** 3)[:, None]
        return torch.zeros(self.n_vertices, dtype=rho.dtype,
                           device=self.device).index_add_(
            0, self.cell2v.reshape(-1), fl.reshape(-1))

    def boundary_field(self, dipole: torch.Tensor,
                       dtype=torch.float64) -> torch.Tensor:
        """The field that is zero on the free vertices: the dipole far
        field on the Dirichlet ones, hanging ones from their masters."""
        x = self.positions()[self.dirichlet]
        g = torch.zeros(self.n_vertices, dtype=torch.float64,
                        device=self.device)
        g[self.dirichlet] = (x @ dipole) / torch.linalg.vector_norm(
            x, dim=-1) ** 3
        return self.distribute(g).to(dtype)


def vertex_values(mesh: Mesh, positions, values) -> tuple:
    """The values ``values`` given at ``positions`` as a vector over the
    mesh's vertices, and the number of positions that are no vertex plus
    vertices that got no value (0 when the two sets are one)."""
    dev = mesh.device
    P = torch.as_tensor(positions, dtype=torch.float64, device=dev)
    u = torch.as_tensor(values, dtype=torch.float64, device=dev)
    c = torch.round((P - mesh.lower) / mesh.hn)
    off_grid = (P - (mesh.lower + mesh.hn * c)).abs().amax(-1) > 1e-9 * (
        1.0 + P.abs().amax(-1))
    c = c.to(torch.int64)
    outside = ((c < 0) | (c > mesh.S)).any(-1) | off_grid
    vid = mesh.lookup(mesh.key(c.clamp(0, mesh.S)))
    vid = torch.where(outside, -1, vid)
    out = torch.zeros(mesh.n_vertices, dtype=torch.float64, device=dev)
    seen = torch.zeros(mesh.n_vertices, dtype=torch.int64, device=dev)
    ok = vid >= 0
    out[vid[ok]] = u[ok]
    seen.index_add_(0, vid[ok], torch.ones_like(vid[ok]))
    mismatch = int((~ok).sum()) + int((seen != 1).sum())
    return out, mismatch


def system_parts(mesh: Mesh, atoms_pos, atoms_q, r_c: float, cut: float,
                 members=None, dtype=torch.float64):
    """(load F, boundary field u_g) in ``dtype``; ``members`` is the
    member table of the base grid (computed when not given)."""
    dev = mesh.device
    pos = torch.as_tensor(atoms_pos, dtype=torch.float64, device=dev)
    q = torch.as_tensor(atoms_q, dtype=torch.float64, device=dev)
    if members is None:
        members = member_table(mesh.reps, mesh.lower, mesh.h0, pos, cut)
    rho = density_at(mesh, members, pos, q, r_c, dtype=dtype)
    F = mesh.load(rho)
    ug = mesh.boundary_field(pos.T @ q, dtype=dtype)
    return F, ug


def residual(mesh: Mesh, F: torch.Tensor, ug: torch.Tensor,
             u: torch.Tensor) -> float:
    """``|C^T (F - K u)|_free / |C^T (F - K u_g)|_free`` in float64."""
    r = mesh.condense(F - mesh.apply_k(u))
    b = mesh.condense(F - mesh.apply_k(ug))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def control_solution(mesh: Mesh, atoms_pos, atoms_q, r_c: float, cut: float,
                     dtype, maxiter: int = 4000, rtol: float = 1e-8,
                     members=None):
    """The reference in the program's place, computed in ``dtype``:
    density, load, boundary field and a Jacobi-preconditioned CG on the
    free vertices, from zero, to ``rtol`` of its own recurrence or
    ``maxiter``.  Returns (the distributed solution as float64 over the
    vertices, CG iterations)."""
    F, ug = system_parts(mesh, atoms_pos, atoms_q, r_c, cut, members, dtype)
    free = mesh.free

    def full(x):
        u = torch.zeros(mesh.n_vertices, dtype=dtype, device=mesh.device)
        u[free] = x
        return mesh.distribute(u)

    A = lambda x: mesh.condense(mesh.apply_k(full(x)))
    b = mesh.condense(F - mesh.apply_k(ug))
    dk = torch.zeros(mesh.n_vertices, dtype=dtype, device=mesh.device)
    dk.index_add_(0, mesh.cell2v.reshape(-1),
                  (torch.diagonal(KREF).to(mesh.device, dtype)[None]
                   * mesh.h.to(dtype)[:, None]).reshape(-1))
    dinv = 1.0 / dk[free]
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z.clone()
    rz = (r * z).sum()
    tol = rtol * float(torch.linalg.vector_norm(b.to(torch.float64)))
    it = 0
    while it < maxiter and float(torch.linalg.vector_norm(
            r.to(torch.float64))) > tol:
        Ap = A(p)
        alpha = rz / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return (full(x) + ug).to(torch.float64), it
