"""O(N) atom-cell locality via spatial hashing.

The reference's ``rhs_assembly_optimization`` (src/step-50.cc:260-306)
tests EVERY atom against EVERY cell vertex — 6,871 s of the 20,540 s
64k-atom run (SSOR_64k_atoms.o876224:68).  Here atoms are bucketed on a
uniform grid of pitch >= cutoff, each mesh cell probes only the buckets
its cutoff-inflated bounding box overlaps, and the exact reference
criterion (atom within ``cutoff * r_c`` of ANY cell vertex) is applied to
the candidates only: O(cells * local_atoms) with a dense-mask-identical
result, emitted as compact per-cell atom lists (:class:`AtomLists`) for
``ops.density.compute_density``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from coulomb_gmg_tpu_torch.mesh.forest import Forest, corner_offsets


def build_atom_buckets(positions: np.ndarray, pitch: float,
                       origin: np.ndarray):
    """Bucket atoms on a uniform grid: returns (order, starts, shape) where
    ``order`` sorts atoms by bucket and ``starts`` is the CSR offset per
    linearized bucket id (+1 sentinel)."""
    dim = positions.shape[1]
    ijk = np.floor((positions - origin) / pitch).astype(np.int64)
    lo = ijk.min(axis=0)
    ijk -= lo
    shape = ijk.max(axis=0) + 1
    lin = ijk[:, 0]
    for d in range(1, dim):
        lin = lin * shape[d] + ijk[:, d]
    order = np.argsort(lin, kind="stable")
    nb = int(np.prod(shape))
    counts = np.bincount(lin, minlength=nb)
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts, shape, lo


@dataclasses.dataclass(frozen=True)
class AtomLists:
    """Per-cell atom lists in compact form: list row r holds the atom ids
    ``atoms[ptr[r]:ptr[r + 1]]``, and active cell c reads row ``home[c]``.

    The lists are built once, at cycle 0, one row a cell; the reference's
    children inherit their parent's list (src/step-50.cc:441-456), so a
    later cell's list is its cycle-0 ancestor's and refinement carries
    ``home`` alone (:meth:`carried`), never the atom ids."""
    ptr: np.ndarray        # (rows + 1,) int64
    atoms: np.ndarray      # (ptr[-1],) int32
    home: np.ndarray       # (n_cells,) int32: each active cell's row

    @classmethod
    def from_rows(cls, counts: np.ndarray, atoms: np.ndarray) -> "AtomLists":
        """One row a cell: cell c's ``counts[c]`` atoms follow cell c - 1's
        in ``atoms``."""
        ptr = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        return cls(ptr, np.ascontiguousarray(atoms, np.int32),
                   np.arange(len(counts), dtype=np.int32))

    @classmethod
    def from_padded(cls, lists: np.ndarray) -> "AtomLists":
        """From (n_cells, K) lists padded with -1 at each row's end."""
        lists = np.asarray(lists)
        valid = lists >= 0
        return cls.from_rows(valid.sum(axis=1), lists[valid])

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "AtomLists":
        """From a (n_cells, n_atoms) bool mask, each row's atoms ascending
        (``ops.density.masks_to_lists``' order)."""
        mask = np.asarray(mask, bool)
        return cls.from_rows(mask.sum(axis=1), np.nonzero(mask)[1])

    @property
    def n_cells(self) -> int:
        return len(self.home)

    @property
    def counts(self) -> np.ndarray:
        """(n_cells,) int64: the length of each cell's list."""
        return np.diff(self.ptr)[self.home]

    def carried(self, omap: np.ndarray) -> "AtomLists":
        """The lists of a refined mesh whose cell i covers old cell
        ``omap[i]``: each child reads its parent's row."""
        return dataclasses.replace(self, home=self.home[np.asarray(omap)])

    def select(self, cells: Optional[range]) -> "AtomLists":
        """The lists of the cells ``cells`` (a range, None for all)."""
        if cells is None:
            return self
        return dataclasses.replace(self,
                                   home=self.home[cells.start:cells.stop])

    def _entries(self):
        """(cell, slot, atom id) of every entry of the cells' lists."""
        counts = self.counts
        cell = np.repeat(np.arange(self.n_cells), counts)
        slot = np.arange(len(cell)) - (np.cumsum(counts) - counts)[cell]
        return cell, slot, self.atoms[self.ptr[self.home][cell] + slot]

    def padded(self, pad_to: Optional[int] = None) -> np.ndarray:
        """(n_cells, K) int32 lists, -1 padded, K the longest list (at
        least 1) or ``pad_to``: the JAX module's layout."""
        counts = self.counts
        K = max(int(counts.max()) if len(counts) else 0, 1) \
            if pad_to is None else pad_to
        out = np.full((self.n_cells, K), -1, np.int32)
        cell, slot, ids = self._entries()
        out[cell, slot] = ids
        return out

    def mask(self, n_atoms: int) -> np.ndarray:
        """(n_cells, n_atoms) bool: atom a is in cell c's list (the JAX
        driver's locality up to 64 atoms)."""
        out = np.zeros((self.n_cells, n_atoms), bool)
        cell, _, ids = self._entries()
        out[cell, ids] = True
        return out


def atom_lists(forest: Forest, positions: np.ndarray, cutoff: float,
               chunk: int = 262144) -> Tuple[np.ndarray, np.ndarray]:
    """Padded per-cell atom index lists (n_cells, K) int32, -1 padded, plus
    per-cell counts: :func:`locality_lists` in the JAX module's layout."""
    lists = locality_lists(forest, positions, cutoff, chunk)
    return lists.padded(), lists.counts


def locality_lists(forest: Forest, positions: np.ndarray, cutoff: float,
                   chunk: int = 262144) -> "AtomLists":
    """Compact per-cell atom lists, one row a cell, each row's atoms in
    bucket order: identical membership to ``ops.density.atom_masks``
    (vertex-distance criterion, src/step-50.cc:273-283) but built in
    O(cells * atoms_within_cutoff)."""
    dim = forest.dim
    n_cells = forest.n_cells
    positions = np.asarray(positions, np.float64)
    if len(positions) == 0:
        return AtomLists.from_rows(np.zeros(n_cells, np.int64),
                                   np.zeros(0, np.int32))

    pitch = max(cutoff, 1e-12)
    origin = positions.min(axis=0)
    order, starts, shape, lo = build_atom_buckets(positions, pitch, origin)
    sorted_pos = positions[order]

    lower = forest.cell_lower()
    h = forest.cell_h()

    # native engine path: the whole bucket-probe + corner-criterion loop in
    # parallel C++ with no host temporaries (native/forest_engine.cpp)
    from coulomb_gmg_tpu_torch.utils import native
    nat = native.atom_lists(lower, h, sorted_pos, order, starts,
                            np.asarray(shape), origin + lo * pitch,
                            pitch, cutoff)
    if nat is not None:
        ptr, atoms = nat
        return AtomLists(ptr, atoms, np.arange(n_cells, dtype=np.int32))

    off = corner_offsets(dim).astype(np.float64)
    c2 = cutoff * cutoff

    rows_out, atoms_out = [], []
    for s in range(0, n_cells, chunk):
        e = min(s + chunk, n_cells)
        lo_box = lower[s:e] - cutoff
        hi_box = lower[s:e] + h[s:e, None] + cutoff
        blo = np.floor((lo_box - origin) / pitch).astype(np.int64) - lo
        bhi = np.floor((hi_box - origin) / pitch).astype(np.int64) - lo
        np.clip(blo, 0, shape - 1, out=blo)
        np.clip(bhi, 0, shape - 1, out=bhi)
        spans = bhi - blo + 1                      # (m, dim)
        # enumerate (cell, bucket) pairs for the overlapped bucket boxes
        n_buckets = np.prod(spans, axis=1)
        cell_rep = np.repeat(np.arange(s, e), n_buckets)
        base = np.repeat(np.concatenate([[0], np.cumsum(n_buckets)[:-1]]),
                         n_buckets)
        local = np.arange(len(cell_rep)) - base
        # decode local -> per-axis bucket offsets
        bidx = np.zeros((len(cell_rep), dim), dtype=np.int64)
        rem = local
        for d in range(dim - 1, -1, -1):
            sp = spans[cell_rep - s, d]
            bidx[:, d] = rem % sp
            rem //= sp
        bcoord = blo[cell_rep - s] + bidx
        blin = bcoord[:, 0]
        for d in range(1, dim):
            blin = blin * shape[d] + bcoord[:, d]
        bstart = starts[blin]
        bcount = starts[blin + 1] - bstart
        # expand to (cell, atom-candidate) pairs
        pair_cell = np.repeat(cell_rep, bcount)
        pbase = np.repeat(np.concatenate([[0], np.cumsum(bcount)[:-1]]),
                          bcount)
        pl = np.arange(len(pair_cell)) - pbase
        cand = np.repeat(bstart, bcount) + pl       # index into sorted_pos
        # exact criterion: atom within cutoff of ANY cell vertex.  The min
        # over the 2^dim corners of an axis-aligned box factorizes per axis:
        #   min_v |x - v|^2 = sum_d min((x_d - lo_d)^2, (x_d - lo_d - h)^2)
        # — one pass instead of 2^dim.
        cpos = sorted_pos[cand]
        cl = lower[pair_cell]
        ch = h[pair_cell]
        d2 = np.zeros(len(pair_cell))
        for d in range(dim):
            a = cpos[:, d] - cl[:, d]
            b = a - ch
            d2 += np.minimum(a * a, b * b)
        keep = d2 < c2
        rows_out.append(pair_cell[keep])
        atoms_out.append(order[cand[keep]])

    rows = np.concatenate(rows_out) if rows_out else np.zeros(0, np.int64)
    atoms = np.concatenate(atoms_out) if atoms_out else np.zeros(0, np.int64)
    ordr = np.argsort(rows, kind="stable")
    return AtomLists.from_rows(np.bincount(rows, minlength=n_cells),
                               atoms[ordr])
