"""Array-based forest-of-octrees adaptive mesh.

TPU-native replacement for the reference's p4est-backed
``parallel::distributed::Triangulation`` (``src/step-50.cc:120-122``): cells
are flat integer arrays (level + integer lattice coordinates), refinement is
vectorized child emission + canonical re-sort, and 2:1 *vertex* balance
(deal.II's ``limit_level_difference_at_vertices``) is a vectorized cascade.

The forest itself (``level``, ``ijk``, ``refine``, ``balance_flags``,
``coarsen``) is host numpy.  Its derived topology (the key helpers,
:class:`KeyIndex`, ``level_cells`` and the DoF numbering of ``dofs_of``) is
torch code on ``Forest.device``: the card when the driver runs there, the
CPU otherwise.  The key helpers take a tensor or a numpy array and give
back the same kind (a numpy argument runs the same torch code on a CPU
view of it).

Geometry convention: the level-0 ("base") mesh is ``R^dim`` cubic cells of
size ``h0`` anchored at ``lower``; a cell at level ``l`` has integer coords
``ijk`` in the ``(R * 2^l)^dim`` lattice and physical box
``lower + h_l * ijk .. lower + h_l * (ijk + 1)`` with ``h_l = h0 / 2^l``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import cached_property, wraps
from typing import List, Optional, Tuple

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload


def to_host(a) -> np.ndarray:
    """numpy of a tensor: a CPU tensor's own memory, a card tensor through
    one copy into pinned host memory.  numpy passes through."""
    if not isinstance(a, torch.Tensor):
        return a
    if a.device.type == "cpu":
        return a.numpy()
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    out.copy_(a)
    return out.numpy()


def _int64(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if a.dtype == torch.int64 else a.to(torch.int64)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _same_kind(pos: int):
    """Run a torch body on the array argument at position ``pos``, as
    int64: a numpy argument goes in as a CPU tensor and comes back as
    numpy."""
    def wrap(fn):
        @wraps(fn)
        def run(self, *args):
            args = list(args)
            host = not isinstance(args[pos], torch.Tensor)
            args[pos] = _int64(args[pos])
            out = fn(self, *args)
            return out.numpy() if host else out
        return run
    return wrap


class KeyIndex:
    """Sorted unique int64 key set with O(log n) lookup
    (``torch.searchsorted``) on the keys' device.  Lookups give back the
    query's kind: tensor or numpy."""

    def __init__(self, keys):
        self.keys = torch.unique(_int64(keys))

    def __len__(self) -> int:
        return len(self.keys)

    def lookup(self, query):
        """Positions of `query` in the key set, -1 where absent."""
        if not isinstance(query, torch.Tensor):
            return self.lookup(_int64(query)).numpy()
        q = query.to(torch.int64).contiguous()
        if len(self.keys) == 0:
            return torch.full_like(q, -1)
        pos = torch.searchsorted(self.keys, q)
        hit = self.keys[pos.clamp(max=len(self.keys) - 1)] == q
        return torch.where(hit, pos, -1)

    def contains(self, query):
        return self.lookup(query) >= 0

    @staticmethod
    def with_order(keys):
        """(KeyIndex, order) for keys KNOWN UNIQUE (e.g. level-cell keys):
        one sort serves both the index and the position->original map.
        ``order`` has the kind of ``keys``."""
        t = _int64(keys)
        order = torch.argsort(t, stable=True)
        ki = KeyIndex.__new__(KeyIndex)
        ki.keys = t[order]
        return ki, (order if isinstance(keys, torch.Tensor)
                    else order.numpy())


def active_level_index(f: "Forest") -> dict:
    """Per level l of ``f``: (KeyIndex of its active level-l cells, their
    active indices in key order), on ``f.device``."""
    out = {}
    for l in range(f.n_levels):
        sel = torch.nonzero(f.level_t == l).reshape(-1)
        ki, order = KeyIndex.with_order(f.level_cell_key(l, f.ijk_t[sel]))
        out[l] = (ki, sel[order])
    return out


def corner_offsets(dim: int) -> np.ndarray:
    """(2^dim, dim) corner offsets in deal.II vertex order (x fastest)."""
    n = 2 ** dim
    out = np.zeros((n, dim), dtype=np.int64)
    for v in range(n):
        for d in range(dim):
            out[v, d] = (v >> d) & 1
    return out


def node_offsets(dim: int, degree: int) -> np.ndarray:
    """((degree+1)^dim, dim) Q_degree node offsets in units of the node
    spacing, matching the element-table basis ordering (x fastest:
    digit_d = (b // (p+1)^d) % (p+1), see ops/q1.py:element_tables).
    degree 1 reduces to :func:`corner_offsets`."""
    p1 = degree + 1
    n = p1 ** dim
    out = np.zeros((n, dim), dtype=np.int64)
    for b in range(n):
        for d in range(dim):
            out[b, d] = (b // (p1 ** d)) % p1
    return out


def _canonical_order(base_reps: int, dim: int, level: np.ndarray,
                     ijk: np.ndarray) -> np.ndarray:
    """Tree-DFS order: base cell (x most significant), then refinement path
    with deal.II child numbering (bit d = axis d)."""
    if len(level) == 0:
        return np.zeros(0, dtype=np.int64)
    lmax = int(level.max())
    lvl64 = level.astype(np.int64)
    base = ijk // (1 << lvl64[:, None])
    cols = []
    for d in range(1, lmax + 1):
        have = lvl64 >= d
        sh = np.maximum(lvl64 - d, 0)
        child = np.zeros(len(level), dtype=np.int64)
        for dd in range(dim):
            child |= np.where(have, (ijk[:, dd] >> sh) & 1, 0) << dd
        cols.append(child)
    base_key = base[:, 0].astype(np.int64)
    for d in range(1, dim):
        base_key = base_key * base_reps + base[:, d]
    return np.lexsort(cols[::-1] + [base_key])


@dataclass(frozen=True)
class Forest:
    dim: int
    base_reps: int                 # R: level-0 cells per axis
    lower: np.ndarray              # (dim,)
    h0: float                      # level-0 cell size
    level: np.ndarray              # (n_cells,) int32, per active cell
    ijk: np.ndarray                # (n_cells, dim) int64
    # where the derived topology (level_cells, dofs_of) is built
    device: torch.device = field(default=torch.device("cpu"), compare=False)

    def on(self, device) -> "Forest":
        """The same forest with its derived topology built on ``device``."""
        return dataclasses.replace(self, device=torch.device(device))

    @cached_property
    def level_t(self) -> torch.Tensor:
        """``level`` as an int64 tensor on ``device``."""
        return upload(self.level, self.device, torch.int64)

    @cached_property
    def ijk_t(self) -> torch.Tensor:
        """``ijk`` as an int64 tensor on ``device``."""
        if isinstance(self.ijk, torch.Tensor):
            return _int64(self.ijk).to(self.device)
        return upload(np.ascontiguousarray(self.ijk, dtype=np.int64),
                      self.device)

    # ------------------------------------------------------------ basics

    @property
    def n_cells(self) -> int:
        return len(self.level)

    @cached_property
    def max_level(self) -> int:
        return int(self.level.max()) if self.n_cells else 0

    @property
    def n_levels(self) -> int:
        return self.max_level + 1

    def h(self, level) -> np.ndarray:
        return self.h0 / (2.0 ** np.asarray(level, dtype=np.float64))

    def side(self, level: int) -> int:
        """Cells per axis of the level-`level` lattice."""
        return self.base_reps * (1 << level)

    @cached_property
    def fine_side(self) -> int:
        """Cells per axis of the finest lattice (level = max_level)."""
        return self.base_reps << self.max_level

    def vkey(self, coords: np.ndarray) -> np.ndarray:
        """Linearize finest-lattice vertex coords (..., dim) -> int64 keys."""
        return self.nkey(coords, 1)

    def vkey_to_coords(self, keys: np.ndarray) -> np.ndarray:
        return self.nkey_to_coords(keys, 1)

    def vertex_position(self, coords: np.ndarray) -> np.ndarray:
        """Physical position of finest-lattice vertex coords (..., dim)."""
        return self.node_position(coords, 1)

    # Q_degree node lattice: the finest cell lattice subdivided `degree`
    # times per axis, so every Q_degree dof of every cell is an integer
    # lattice point (degree 1 = the vertex lattice).

    @_same_kind(0)
    def nkey(self, coords, degree: int):
        """Linearize node-lattice coords (..., dim) -> int64 keys."""
        m = self.fine_side * degree + 1
        assert float(m) ** self.dim < 2 ** 62, "lattice too fine for int64 keys"
        key = coords[..., 0]
        for d in range(1, self.dim):
            key = key * m + coords[..., d]
        return key

    @_same_kind(0)
    def nkey_to_coords(self, keys, degree: int):
        m = self.fine_side * degree + 1
        out = torch.empty(keys.shape + (self.dim,), dtype=torch.int64,
                          device=keys.device)
        for d in range(self.dim - 1, -1, -1):
            out[..., d] = keys % m
            keys = keys // m
        return out

    def node_position(self, coords, degree: int):
        """Physical position of node-lattice coords (..., dim), float64."""
        hn = self.h0 / ((1 << self.max_level) * degree)
        c = coords if isinstance(coords, torch.Tensor) else _int64(coords)
        lower = upload(np.asarray(self.lower, np.float64), c.device)
        out = lower + hn * c.to(torch.float64)
        return out if isinstance(coords, torch.Tensor) else out.numpy()

    @_same_kind(1)
    def level_cell_key(self, level, ijk):
        """Linearized per-level cell key (no level tag; caller keeps levels
        separate)."""
        side = self.side(int(np.max(level)) if np.ndim(level) else int(level))
        key = ijk[..., 0]
        for d in range(1, self.dim):
            key = key * side + ijk[..., d]
        return key

    # ------------------------------------------------------- constructors

    @staticmethod
    def uniform(dim: int, reps: int, lower, h0: float,
                device="cpu") -> "Forest":
        """Base mesh: `reps`^dim cells — the analogue of
        ``GridGenerator::subdivided_hyper_rectangle`` (src/step-50.cc:1526)."""
        axes = [np.arange(reps, dtype=np.int64)] * dim
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        ijk = grid.reshape(-1, dim)   # x slowest — matches _canonical_order
        return Forest(dim=dim, base_reps=reps,
                      lower=np.asarray(lower, dtype=np.float64), h0=float(h0),
                      level=np.zeros(len(ijk), dtype=np.int32), ijk=ijk,
                      device=torch.device(device))

    @staticmethod
    def hyper_cube(dim: int, left: float, right: float,
                   n_global_refinements: int, device="cpu") -> "Forest":
        """``GridGenerator::hyper_cube`` + ``refine_global(n)``
        (src/step-50.cc:1496-1497): a single base cell refined globally so
        the multigrid hierarchy retains every level 0..n."""
        f = Forest.uniform(dim, 1, np.full(dim, left), right - left, device)
        for _ in range(n_global_refinements):
            f = f.refine(np.ones(f.n_cells, dtype=bool))
        return f

    # ---------------------------------------------------------- refinement

    def refine(self, flags: np.ndarray, balance: bool = True) -> "Forest":
        """Replace flagged cells by their ``2^dim`` children; optionally
        enforce 2:1 vertex balance first (cascaded flags)."""
        flags = np.asarray(flags, dtype=bool)
        if balance:
            flags = self.balance_flags(flags)
        keep_level = self.level[~flags]
        keep_ijk = self.ijk[~flags]
        par_level = self.level[flags].astype(np.int64)
        par_ijk = self.ijk[flags]
        off = corner_offsets(self.dim)
        ch_ijk = (par_ijk[:, None, :] * 2 + off[None, :, :]).reshape(-1, self.dim)
        ch_level = np.repeat(par_level + 1, 2 ** self.dim).astype(np.int32)
        level = np.concatenate([keep_level, ch_level])
        ijk = np.concatenate([keep_ijk, ch_ijk])
        order = _canonical_order(self.base_reps, self.dim, level, ijk)
        return Forest(self.dim, self.base_reps, self.lower, self.h0,
                      level[order].astype(np.int32), ijk[order], self.device)

    def coarsen(self, flags: np.ndarray) -> "Forest":
        """Replace complete flagged sibling groups by their parent — the
        coarsening half of ``execute_coarsening_and_refinement``
        (src/step-50.cc:1104-1111; the reference app never flags it, this
        is machinery parity with deal.II).

        deal.II flag-cleanup semantics: a group coarsens only if ALL
        ``2^dim`` siblings are active and flagged, and only if the result
        preserves the 2:1 vertex balance — a group whose parent would
        touch a remaining active cell two levels deeper is dropped.
        Levels are processed fine-to-coarse so drops cascade correctly.
        """
        flags = np.asarray(flags, dtype=bool)
        lvl = self.level.astype(np.int64)
        alive = np.ones(self.n_cells, dtype=bool)
        added_level: List[np.ndarray] = []
        added_ijk: List[np.ndarray] = []
        off = corner_offsets(self.dim)
        lmax = self.max_level
        for l in range(lmax, 0, -1):
            idx = np.where(alive & flags & (lvl == l))[0]
            if len(idx) == 0:
                continue
            parent = self.ijk[idx] // 2
            pkey = self.level_cell_key(l - 1, parent)
            uniq, first, inv, counts = np.unique(
                pkey, return_index=True, return_inverse=True,
                return_counts=True)
            complete = counts == 2 ** self.dim
            if not complete.any():
                continue
            # balance: a parent (level l-1) may not touch a REMAINING
            # active cell at level l+1 (closure level difference 2)
            bad = np.zeros(len(uniq), dtype=bool)
            if l + 1 <= lmax:
                rem = np.where(alive & (lvl == l + 1))[0]
                if len(rem):
                    q = self.ijk[rem]
                    rmin = np.maximum((q - 1) // 4, 0)
                    rmax = np.minimum((q + 1) // 4, self.side(l - 1) - 1)
                    cand = (rmin[:, None, :]
                            + off[None, :, :] * (rmax - rmin)[:, None, :])
                    keys = self.level_cell_key(l - 1,
                                               cand.reshape(-1, self.dim))
                    pos = np.searchsorted(uniq, keys)
                    pos = np.clip(pos, 0, len(uniq) - 1)
                    hit = uniq[pos] == keys
                    bad[pos[hit]] = True
            accept = complete & ~bad
            if not accept.any():
                continue
            alive[idx[accept[inv]]] = False
            added_level.append(np.full(accept.sum(), l - 1, dtype=np.int32))
            added_ijk.append(parent[first[accept]])
        if not added_level:
            return self
        level = np.concatenate([self.level[alive]] + added_level)
        ijk = np.concatenate([self.ijk[alive]] + added_ijk)
        order = _canonical_order(self.base_reps, self.dim, level, ijk)
        return Forest(self.dim, self.base_reps, self.lower, self.h0,
                      level[order].astype(np.int32), ijk[order], self.device)

    def balance_flags(self, flags: np.ndarray) -> np.ndarray:
        """Augment refine flags for 2:1 vertex balance.

        Invariant: `self` is already balanced, so a flagged cell at level l
        (children at l+1) can only violate against *touching* active cells at
        level l-1; each such cell is one of the <= 2^dim level-(l-1) cells
        whose closure intersects the flagged cell's closure.  Processing
        levels from fine to coarse cascades in a single pass.
        """
        flags = np.asarray(flags, dtype=bool).copy()
        if not flags.any():
            return flags
        lvl = self.level.astype(np.int64)
        lmax = int(lvl.max())
        # per-level KeyIndex of active cells -> active index
        per_level = {}
        for l in range(lmax + 1):
            sel = np.where(lvl == l)[0]
            ki, order = KeyIndex.with_order(
                self.level_cell_key(l, self.ijk[sel]))
            per_level[l] = (ki, sel[order])
        off = corner_offsets(self.dim)  # reuse as 0/1 offsets
        for l in range(lmax, 0, -1):
            src = np.where(flags & (lvl == l))[0]
            if len(src) == 0:
                continue
            a = self.ijk[src]                       # (m, dim) level-l coords
            # touching level-(l-1) cells: q in {qmin..qmax} per axis, where
            # qmin = (a-1)//2 (a>0) and qmax = (a+1)//2, exactly 2 values.
            qmin = np.maximum((a - 1) // 2, 0)
            qmax = np.minimum((a + 1) // 2, self.side(l - 1) - 1)
            cand = qmin[:, None, :] + off[None, :, :] * (qmax - qmin)[:, None, :]
            ki, act = per_level[l - 1]
            pos = ki.lookup(self.level_cell_key(l - 1, cand.reshape(-1, self.dim)))
            hit = act[pos[pos >= 0]]
            flags[hit] = True
        return flags

    # --------------------------------------------------- geometry queries

    def cell_lower(self, cells: Optional[np.ndarray] = None) -> np.ndarray:
        """(n, dim) physical lower corners of (selected) active cells."""
        if cells is None:
            lvl, ijk = self.level, self.ijk
        else:
            lvl, ijk = self.level[cells], self.ijk[cells]
        return self.lower + self.h(lvl)[:, None] * ijk

    def cell_h(self, cells: Optional[np.ndarray] = None) -> np.ndarray:
        lvl = self.level if cells is None else self.level[cells]
        return self.h(lvl)

    def cell_corner_keys(self) -> np.ndarray:
        """(n_cells, 2^dim) finest-lattice vertex keys of active cells, in
        deal.II vertex order."""
        s = (1 << (self.max_level - self.level.astype(np.int64)))
        off = corner_offsets(self.dim)
        corners = (self.ijk[:, None, :] + off[None, :, :]) * s[:, None, None]
        return self.vkey(corners)

    # ---------------------------------------------------- DoF enumeration

    @cached_property
    def _dof_cache(self) -> dict:
        return {}

    def dofs_of(self, degree: int = 1):
        """Q_degree DoF enumeration for this forest (cached per degree)."""
        if degree not in self._dof_cache:
            from coulomb_gmg_tpu_torch.mesh.dofs import build_dofs
            self._dof_cache[degree] = build_dofs(self, degree)
        return self._dof_cache[degree]

    @property
    def dofs(self):
        return self.dofs_of(1)

    def drop_dofs(self) -> None:
        """Forget the cached DoF records and their host views.  A record
        refers to its forest and to its host view, and each of them back to
        it, so a forest that has been replaced would keep the records' card
        memory until the interpreter's cycle collector next ran."""
        for d in self._dof_cache.values():
            for rec in (d, *d.levels):
                rec.__dict__.pop("host", None)
        self._dof_cache.clear()

    # --------------------------------------------------------- level mesh

    @cached_property
    def level_cells(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per level l: (level_ijk (m, dim) int64, active_index (m,) int64
        with -1 where the level cell is a non-active ancestor), tensors on
        ``device``, cells in level-key order.

        Level-l mesh = all tree cells at level l: active cells of level l
        plus level-l ancestors of deeper active cells — deal.II's
        distributed level hierarchy (src/step-50.cc:716-731).
        """
        out = []
        lvl, ijk = self.level_t, self.ijk_t
        for l in range(self.n_levels):
            at = torch.nonzero(lvl == l).reshape(-1)
            deeper = torch.nonzero(lvl > l).reshape(-1)
            anc = ijk[deeper] >> (lvl[deeper, None] - l)
            lin = self.level_cell_key(l, torch.cat([ijk[at], anc]))
            uniq, inv = torch.unique(lin, return_inverse=True)
            keep_act = torch.full((len(uniq),), -1, dtype=torch.int64,
                                  device=lvl.device)
            keep_act[inv[: len(at)]] = at     # active entries win
            side = self.side(l)
            coords = torch.empty((len(uniq), self.dim), dtype=torch.int64,
                                 device=lvl.device)
            rem = uniq
            for d in range(self.dim - 1, -1, -1):
                coords[:, d] = rem % side
                rem = rem // side
            out.append((coords, keep_act))
        return out

    @cached_property
    def level_cells_host(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """``level_cells`` as numpy, for host consumers."""
        return [(to_host(c), to_host(a)) for c, a in self.level_cells]
