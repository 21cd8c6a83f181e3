"""DoF enumeration, hanging-node constraints, and level (multigrid) DoFs.

TPU-native replacement for deal.II's ``DoFHandler::distribute_dofs`` /
``distribute_mg_dofs`` / ``make_hanging_node_constraints`` /
``MGConstrainedDoFs`` stack (``src/step-50.cc:650-731``).  Global DoF ids are
the sort order of finest-lattice vertex keys — deterministic and independent
of traversal, so all reductions (norms, counts) are partition invariant.

Supports arbitrary polynomial degree (the reference's "Polynomial degree"
parameter, ``src/step-50.cc:80``): Q_p dofs are points of the node lattice
(the finest cell lattice subdivided p times per axis), hanging constraints
interpolate through the coarse side's face/edge Lagrange basis, and every
multigrid level carries its own Q_p node set.

The numbering, the hanging-node pairs and the level DoFs are torch code on
the forest's device (``Forest.device``): their arrays are tensors there.
Host consumers (constraints, the assembly plan, output) read them through
``DofInfo.host`` / ``LevelDofs.host``, one copy per array.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.forest import (Forest, KeyIndex, node_offsets,
                                               to_host)


@dataclass
class Constraints:
    """Resolved affine constraints ``x_c = sum_j w_j x_j + g_c``.

    CSR layout over the *constrained* dofs only.  After resolution, all
    referenced columns are unconstrained dofs (chains eliminated, like
    ``ConstraintMatrix::close()``).
    """

    rows: np.ndarray       # (n_constrained,) global dof ids, sorted
    indptr: np.ndarray     # (n_constrained + 1,)
    cols: np.ndarray       # (nnz,) global dof ids (unconstrained)
    weights: np.ndarray    # (nnz,)
    inhomog: np.ndarray    # (n_constrained,) g_c
    n_dofs: int

    @property
    def is_constrained(self) -> np.ndarray:
        mask = np.zeros(self.n_dofs, dtype=bool)
        mask[self.rows] = True
        return mask

    def row_of(self, dofs: np.ndarray) -> np.ndarray:
        """Index into `rows` for each dof (-1 if unconstrained)."""
        pos = np.searchsorted(self.rows, dofs)
        pos = np.clip(pos, 0, max(len(self.rows) - 1, 0))
        if len(self.rows) == 0:
            return np.full(np.shape(dofs), -1, dtype=np.int64)
        hit = self.rows[pos] == dofs
        return np.where(hit, pos, -1)


class HostView:
    """numpy view of a record whose arrays are tensors on a device: each
    array is copied to the host once, on first use (``to_host``); lists of
    records give their own views."""

    def __init__(self, rec):
        self._rec = rec

    def __getattr__(self, name):
        v = getattr(self._rec, name)
        if isinstance(v, torch.Tensor):
            v = to_host(v)
        elif isinstance(v, tuple):
            v = tuple(to_host(x) for x in v)
        elif isinstance(v, list):
            v = [x.host if hasattr(x, "host") else x for x in v]
        self.__dict__[name] = v
        return v


@dataclass
class LevelDofs:
    """DoFs of the level-l mesh (all tree cells at level l); tensors on the
    forest's device."""

    level: int
    keys: torch.Tensor          # sorted unique node-lattice keys
    cell2dof: torch.Tensor      # (n_level_cells, (p+1)^dim) level-dof ids
    active_index: torch.Tensor  # (n_level_cells,) active cell id or -1
    boundary: torch.Tensor      # (n_dofs,) bool: on domain boundary
    interface: torch.Tensor     # (n_dofs,) bool: on refinement edge
    n_dofs: int
    degree: int = 1

    @cached_property
    def host(self) -> HostView:
        return HostView(self)


@dataclass
class DofInfo:
    """Global DoFs; tensors on the forest's device."""

    forest: Forest
    keys: torch.Tensor          # sorted unique node keys -> global dof id
    cell2dof: torch.Tensor      # (n_cells, (p+1)^dim) int64
    boundary: torch.Tensor      # (n_dofs,) bool
    positions: torch.Tensor     # (n_dofs, dim) float64
    levels: List[LevelDofs]
    hanging_pairs: tuple        # raw (rows, cols, weights) pre-resolution
    degree: int = 1

    @property
    def n_dofs(self) -> int:
        return len(self.keys)

    @cached_property
    def host(self) -> HostView:
        return HostView(self)


def _cell_node_keys(forest: Forest, degree: int) -> torch.Tensor:
    """(n_cells, (p+1)^dim) node-lattice keys of active cells, in the
    element-table basis order."""
    lvl, ijk = forest.level_t, forest.ijk_t
    s = torch.ones_like(lvl) << (forest.max_level - lvl)
    off = upload(node_offsets(forest.dim, degree), lvl.device)
    # node coord = cell base (fine lattice) * degree + offset * cell size
    nodes = (ijk[:, None, :] * degree + off[None, :, :]) * s[:, None, None]
    return forest.nkey(nodes, degree)


def _index(keys: torch.Tensor) -> KeyIndex:
    kidx = KeyIndex.__new__(KeyIndex)
    kidx.keys = keys
    return kidx


def _numbering(forest: Forest, keys: torch.Tensor, degree: int):
    """Sorted unique keys of a node-key table, the table as ids into them,
    and the boundary flag of each unique node."""
    uniq, inverse = torch.unique(keys.reshape(-1), return_inverse=True)
    coords = forest.nkey_to_coords(uniq, degree)
    S = forest.fine_side * degree
    boundary = ((coords == 0) | (coords == S)).any(dim=1)
    return uniq, inverse.reshape(keys.shape), coords, boundary


def build_dofs(forest: Forest, degree: int = 1) -> DofInfo:
    ckeys = _cell_node_keys(forest, degree)
    uniq, cell2dof, coords, boundary = _numbering(forest, ckeys, degree)
    positions = forest.node_position(coords, degree)
    hanging = _find_hanging(forest, _index(uniq), degree)
    levels = [_build_level(forest, l, degree) for l in range(forest.n_levels)]
    return DofInfo(forest=forest, keys=uniq, cell2dof=cell2dof,
                   boundary=boundary, positions=positions, levels=levels,
                   hanging_pairs=hanging, degree=degree)


# ------------------------------------------------------------ hanging nodes

def _find_hanging(forest: Forest, kidx: KeyIndex, degree: int = 1):
    """Hanging node detection for Q_degree.

    With 2:1 vertex balance, a dof hangs iff it lies on a face (3D also:
    edge) of a coarser active cell at a position that is a node of the FINE
    side's lattice (spacing s/2 in node units for a coarse cell of node
    spacing s) but not a node of the coarse cell itself.  Its constraint is
    interpolation through the coarse cell's facet Lagrange basis: 1D basis
    of the p+1 edge nodes for edge points, tensor-product 2D basis of the
    (p+1)^2 face nodes for face-interior points — deal.II
    ``make_hanging_node_constraints`` semantics.  Q1 reduces to the classic
    1/2-1/2 edge-midpoint and 1/4 face-center weights.

    Returns flat triples (rows, cols, weights) over kidx positions, tensors
    on the forest's device.  Chains are resolved later against Dirichlet
    data in ``fem.constraints.build_constraints``.
    """
    from coulomb_gmg_tpu_torch.ops.q1 import lagrange_nodes_1d, _lagrange_eval

    dim = forest.dim
    p = degree
    L = forest.max_level
    lvl, ijk = forest.level_t, forest.ijk_t
    dev = lvl.device
    coarse = torch.nonzero(lvl < L).reshape(-1)   # only these can have
    empty = (torch.zeros(0, dtype=torch.int64, device=dev),  # finer face
             torch.zeros(0, dtype=torch.int64, device=dev),  # neighbors
             torch.zeros(0, dtype=torch.float64, device=dev))
    if len(coarse) == 0:
        return empty
    s = torch.ones_like(coarse) << (L - lvl[coarse])  # fine-lattice size
    base = ijk[coarse] * p * s[:, None]               # node-lattice base
    half = s // 2
    # cell size in node units = s*p; own node spacing = s; candidate (fine
    # side) spacing = s//2 — integer because lvl < L.
    nodes1 = lagrange_nodes_1d(p)
    tgrid = np.arange(1, 2 * p) / (2.0 * p)        # candidate fractions
    lag = _lagrange_eval(nodes1, tgrid)[0]         # (2p-1, p+1) basis values

    # Candidates by facet kind (edges, then faces: the order of the
    # emission): per candidate its keys (m,), its facet's column keys
    # (m, k) and its weights (k,).  One selection a kind keeps the
    # candidates present in the dof set, in emission order.
    kinds = []

    def _kind():
        kinds.append(([], [], [], []))    # candidates, facets, facet, w
        return kinds[-1]

    def _edge(kind, axis, fixed):
        """Edge along `axis` with the other axes fixed at 0 or cell-size;
        fixed: {other_axis: 0|1}."""
        cands, facets, facet, ws = kind
        e_base = base.clone()
        for d, sidev in fixed.items():
            e_base[:, d] += sidev * s * p
        cols = []
        for j in range(p + 1):
            c = e_base.clone()
            c[:, axis] += j * s
            cols.append(forest.nkey(c, p))
        facets.append(torch.stack(cols, dim=1))
        # candidate points at odd multiples of s/2 along the edge
        for k in range(1, 2 * p, 2):
            cand = e_base.clone()
            cand[:, axis] += k * half
            cands.append(forest.nkey(cand, p))
            facet.append(len(facets) - 1)
            ws.append(lag[k - 1])   # tgrid index of k/(2p) is k-1

    def _face(kind, axis, sidev, o1, o2):
        cands, facets, facet, ws = kind
        f_base = base.clone()
        f_base[:, axis] += sidev * s * p
        cols = []
        for j1 in range(p + 1):
            for j2 in range(p + 1):
                c = f_base.clone()
                c[:, o1] += j1 * s
                c[:, o2] += j2 * s
                cols.append(forest.nkey(c, p))
        facets.append(torch.stack(cols, dim=1))
        for k1 in range(1, 2 * p):
            for k2 in range(1, 2 * p):
                if k1 % 2 == 0 and k2 % 2 == 0:
                    continue   # coarse node (or edge-interior coarse node)
                cand = f_base.clone()
                cand[:, o1] += k1 * half
                cand[:, o2] += k2 * half
                cands.append(forest.nkey(cand, p))
                facet.append(len(facets) - 1)
                ws.append([lag[k1 - 1, j1] * lag[k2 - 1, j2]
                           for j1 in range(p + 1) for j2 in range(p + 1)])

    edges = _kind()
    if dim == 2:
        for axis in range(2):
            o = 1 - axis
            for sidev in (0, 1):
                _edge(edges, axis, {o: sidev})
    else:
        for axis in range(3):
            o1, o2 = [d for d in range(3) if d != axis]
            for s1 in (0, 1):
                for s2 in (0, 1):
                    _edge(edges, axis, {o1: s1, o2: s2})
        faces = _kind()
        for axis in range(3):
            o1, o2 = [d for d in range(3) if d != axis]
            for sidev in (0, 1):
                _face(faces, axis, sidev, o1, o2)

    # flatten to per-row variable-width: keep as (rows, cols, w) triples
    rows, cols, wts = [], [], []
    for cands, facets, facet, ws in kinds:
        cands = torch.stack(cands)                       # (E, m)
        # (candidate, cell) pairs present in the dof set, candidate-major
        e, i = torch.nonzero(kidx.contains(cands), as_tuple=True)
        c = kidx.lookup(torch.stack(facets)[
            upload(np.asarray(facet, np.int64), dev)[e], i])  # (n, k)
        k = c.shape[1]
        rows.append(kidx.lookup(cands[e, i])[:, None].expand(-1, k)
                    .reshape(-1))
        cols.append(c.reshape(-1))
        wts.append(upload(np.asarray(ws, np.float64), dev)[e].reshape(-1))
    rows, cols, wts = torch.cat(rows), torch.cat(cols), torch.cat(wts)
    # drop zero weights (a facet-basis value can vanish at a candidate) and
    # columns that are themselves hanging at the SAME position class are
    # impossible by construction (cols are coarse facet nodes).
    nz = torch.nonzero(wts != 0.0).reshape(-1)
    rows, cols, wts = rows[nz], cols[nz], wts[nz]
    # dedupe identical (row, col) pairs (the same point is emitted by every
    # coarse cell sharing the edge/face) — weights agree, keep the first.
    first = _first_of_each(rows * len(kidx) + cols)
    return rows[first], cols[first], wts[first]


def _first_of_each(key: torch.Tensor) -> torch.Tensor:
    """Index of the first occurrence of each distinct value, in value
    order (``np.unique(key, return_index=True)[1]``)."""
    sk, order = torch.sort(key, stable=True)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    return order[start]


def restrict_to_vertices(forest: Forest, dofs_p: DofInfo,
                         u: np.ndarray) -> np.ndarray:
    """Vertex-subset view of a Q_p dof vector as a Q1 dof vector (VTU and
    other vertex-based output paths stay Q1)."""
    if dofs_p.degree == 1:
        return np.asarray(u)
    q1 = forest.dofs.host
    coords = forest.vkey_to_coords(q1.keys)
    pk = forest.nkey(coords * np.int64(dofs_p.degree), dofs_p.degree)
    keys_p = dofs_p.host.keys
    pos = np.searchsorted(keys_p, pk)
    assert (keys_p[pos] == pk).all(), "vertex missing from Q_p node set"
    return np.asarray(u)[pos]


# -------------------------------------------------------------- level dofs

def _build_level(forest: Forest, l: int, degree: int = 1) -> LevelDofs:
    dim = forest.dim
    p = degree
    level_ijk, active_index = forest.level_cells[l]
    s = 1 << (forest.max_level - l)
    off = upload(node_offsets(dim, p), level_ijk.device)
    nodes = (level_ijk[:, None, :] * p + off[None, :, :]) * s
    uniq, cell2dof, _, boundary = _numbering(forest, forest.nkey(nodes, p), p)
    kidx = _index(uniq)

    # refinement-edge (interface) dofs: dofs on faces of level-l cells whose
    # face neighbor is not part of the level-l mesh and is not the domain
    # boundary (deal.II MGConstrainedDoFs::get_refinement_edge_indices,
    # used at src/step-50.cc:860,892).
    # Every cell's face nodes are looked up; those of faces that are not on
    # the refinement edge go to a spare last entry (no selection, no wait).
    n = len(uniq)
    interface = torch.zeros(n + 1, dtype=torch.bool, device=uniq.device)
    if l > 0:
        side = forest.side(l)
        cellset = KeyIndex(forest.level_cell_key(l, level_ijk))
        off_h = node_offsets(dim, p)
        for axis in range(dim):
            for sgn in (-1, 1):
                nb = level_ijk.clone()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side)
                missing = inside & ~cellset.contains(
                    forest.level_cell_key(l, nb))
                face_nodes = upload(
                    off_h[off_h[:, axis] == (p if sgn > 0 else 0)],
                    level_ijk.device)
                fc = (level_ijk[:, None, :] * p + face_nodes[None]) * s
                pos = kidx.lookup(forest.nkey(fc, p))
                interface[torch.where(missing[:, None], pos, n)] = True

    return LevelDofs(level=l, keys=uniq, cell2dof=cell2dof,
                     active_index=active_index, boundary=boundary,
                     interface=interface[:n], n_dofs=n, degree=p)
