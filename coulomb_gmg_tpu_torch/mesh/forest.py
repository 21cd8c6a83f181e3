"""Array-based forest-of-octrees adaptive mesh.

TPU-native replacement for the reference's p4est-backed
``parallel::distributed::Triangulation`` (``src/step-50.cc:120-122``): cells
are flat integer arrays (level + integer lattice coordinates), refinement is
vectorized child emission + canonical re-sort, and 2:1 *vertex* balance
(deal.II's ``limit_level_difference_at_vertices``) is a vectorized cascade.
All topology work happens on host in numpy; the resulting index maps feed
jitted JAX compute.

Geometry convention: the level-0 ("base") mesh is ``R^dim`` cubic cells of
size ``h0`` anchored at ``lower``; a cell at level ``l`` has integer coords
``ijk`` in the ``(R * 2^l)^dim`` lattice and physical box
``lower + h_l * ijk .. lower + h_l * (ijk + 1)`` with ``h_l = h0 / 2^l``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Tuple

import numpy as np


class KeyIndex:
    """Sorted unique int64 key set with O(log n) vectorized lookup.
    Backed by the native topology engine when available
    (native/forest_engine.cpp), numpy otherwise."""

    def __init__(self, keys: np.ndarray):
        from coulomb_gmg_tpu_torch.utils import native
        self.keys, _ = native.sort_unique_inverse(
            np.asarray(keys, dtype=np.int64))

    def __len__(self) -> int:
        return len(self.keys)

    def lookup(self, query: np.ndarray) -> np.ndarray:
        """Positions of `query` in the key set, -1 where absent."""
        from coulomb_gmg_tpu_torch.utils import native
        query = np.asarray(query, dtype=np.int64)
        if len(self.keys) == 0:
            return np.full(query.shape, -1, dtype=np.int64)
        return native.lookup(self.keys, query)

    def contains(self, query: np.ndarray) -> np.ndarray:
        return self.lookup(query) >= 0

    @staticmethod
    def with_order(keys: np.ndarray):
        """(KeyIndex, order) for keys KNOWN UNIQUE (e.g. level-cell keys):
        one sort serves both the index and the position->original map,
        instead of the KeyIndex(keys) + np.argsort(keys) double sort."""
        keys = np.asarray(keys, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        ki = KeyIndex.__new__(KeyIndex)
        ki.keys = keys[order]
        return ki, order


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

    def nkey(self, coords: np.ndarray, degree: int) -> np.ndarray:
        """Linearize node-lattice coords (..., dim) -> int64 keys."""
        m = self.fine_side * degree + 1
        assert float(m) ** self.dim < 2 ** 62, "lattice too fine for int64 keys"
        coords = np.asarray(coords, dtype=np.int64)
        key = coords[..., 0]
        for d in range(1, self.dim):
            key = key * m + coords[..., d]
        return key

    def nkey_to_coords(self, keys: np.ndarray, degree: int) -> np.ndarray:
        m = self.fine_side * degree + 1
        keys = np.asarray(keys, dtype=np.int64)
        out = np.zeros(keys.shape + (self.dim,), dtype=np.int64)
        for d in range(self.dim - 1, -1, -1):
            out[..., d] = keys % m
            keys = keys // m
        return out

    def node_position(self, coords: np.ndarray, degree: int) -> np.ndarray:
        """Physical position of node-lattice coords (..., dim)."""
        hn = self.h0 / ((1 << self.max_level) * degree)
        return self.lower + hn * np.asarray(coords, dtype=np.float64)

    def level_cell_key(self, level, ijk: np.ndarray) -> np.ndarray:
        """Linearized per-level cell key (no level tag; caller keeps levels
        separate)."""
        side = np.int64(self.side(int(np.max(level)) if np.ndim(level) else int(level)))
        ijk = np.asarray(ijk, dtype=np.int64)
        key = ijk[..., 0]
        for d in range(1, self.dim):
            key = key * side + ijk[..., d]
        return key

    # ------------------------------------------------------- constructors

    @staticmethod
    def uniform(dim: int, reps: int, lower, h0: float) -> "Forest":
        """Base mesh: `reps`^dim cells — the analogue of
        ``GridGenerator::subdivided_hyper_rectangle`` (src/step-50.cc:1526)."""
        axes = [np.arange(reps, dtype=np.int64)] * dim
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        ijk = grid.reshape(-1, dim)   # x slowest — matches _canonical_order
        return Forest(dim=dim, base_reps=reps,
                      lower=np.asarray(lower, dtype=np.float64), h0=float(h0),
                      level=np.zeros(len(ijk), dtype=np.int32), ijk=ijk)

    @staticmethod
    def hyper_cube(dim: int, left: float, right: float,
                   n_global_refinements: int) -> "Forest":
        """``GridGenerator::hyper_cube`` + ``refine_global(n)``
        (src/step-50.cc:1496-1497): a single base cell refined globally so
        the multigrid hierarchy retains every level 0..n."""
        f = Forest.uniform(dim, 1, np.full(dim, left), right - left)
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
                      level[order].astype(np.int32), ijk[order])

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
                      level[order].astype(np.int32), ijk[order])

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

    # --------------------------------------------------------- level mesh

    @cached_property
    def level_cells(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per level l: (level_ijk (m, dim) int64, active_index (m,) int64
        with -1 where the level cell is a non-active ancestor).

        Level-l mesh = all tree cells at level l: active cells of level l
        plus level-l ancestors of deeper active cells — deal.II's
        distributed level hierarchy (src/step-50.cc:716-731).
        """
        out = []
        lvl = self.level.astype(np.int64)
        for l in range(self.n_levels):
            at = np.where(lvl == l)[0]
            deeper = np.where(lvl > l)[0]
            anc = self.ijk[deeper] // (1 << (lvl[deeper, None] - l))
            all_ijk = np.concatenate([self.ijk[at], anc])
            act = np.concatenate([at, np.full(len(anc), -1, dtype=np.int64)])
            side = np.int64(self.side(l))
            lin = all_ijk[:, 0].copy()
            for d in range(1, self.dim):
                lin = lin * side + all_ijk[:, d]
            uniq, inv = np.unique(lin, return_inverse=True)
            keep_act = np.full(len(uniq), -1, dtype=np.int64)
            keep_act[inv[: len(at)]] = at     # active entries win
            coords = np.zeros((len(uniq), self.dim), dtype=np.int64)
            rem = uniq.copy()
            for d in range(self.dim - 1, -1, -1):
                coords[:, d] = rem % side
                rem //= side
            out.append((coords, keep_act))
        return out
