"""Level operators of the GMG hierarchy, built on the device from compact
topology.

Counterpart of coulomb_gmg_tpu/ops/stencil.py.  With unit coefficient and
Q1 elements every level mesh is a subset of a uniform lattice, so each level
matrix is a 3^dim-point stencil whose weights at a node depend only on which
of its 2^dim adjacent cells exist: a lookup into the table ``T[mask, o]``.
The reference tables (``offset3``, ``stencil_table``) are numpy, copied
from the JAX module because that module imports jax.  The compact level
inputs (``level_topology``) are torch code on the forest's device, and
``topology_signature`` hashes one host copy of them.  The operator build is
PyTorch on the device; the lexicographic (hi, lo)
int32 bisection of the JAX module (a memory workaround for XLA) becomes one
``torch.searchsorted`` over int64 keys ``hi * (side + 1) + lo``.

Operators come out in the transposed ``(K, n_pad)`` ELL layout that
ops/ell.py consumes, with int32 column indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.forest import (Forest, KeyIndex,
                                               corner_offsets, to_host)
from coulomb_gmg_tpu_torch.mesh.dofs import LevelDofs
from coulomb_gmg_tpu_torch.ops.ell import ell_mv


# ---------------------------------------------------------------------------
# host: stencil table + compact per-level inputs
# ---------------------------------------------------------------------------


def offset3(dim: int) -> np.ndarray:
    """(3^dim, dim) neighbor offsets in {-1,0,1}^dim, x fastest (axis 0 is
    the least-significant digit — the same digit convention as
    mesh/forest.py:node_offsets)."""
    n = 3 ** dim
    out = np.zeros((n, dim), dtype=np.int64)
    for o in range(n):
        r = o
        for d in range(dim):
            out[o, d] = r % 3 - 1
            r //= 3
    return out


def stencil_table(dim: int, tables) -> np.ndarray:
    """T[mask, o]: stencil weight of neighbor offset ``o`` at a node whose
    adjacent-cell existence bitset is ``mask`` (bit c set = the cell with
    lower corner at node - corner_offsets[c] exists), for h = 1.  Scale by
    ``h^(dim-2)`` per level.  Unit coefficient only."""
    w = np.asarray(tables.weights, np.float64)
    G = np.asarray(tables.grad_outer, np.float64)
    k_ref = np.einsum("q,qij->ij", w, G)            # (nb, nb), nb = 2^dim
    nb = 2 ** dim
    offs = offset3(dim)
    corners = corner_offsets(dim)
    T = np.zeros((2 ** nb, 3 ** dim))
    for c in range(nb):                              # cell c: node is its
        a = c                                        # local corner a = c
        for o in range(3 ** dim):
            b_off = offs[o] + corners[c]
            if ((b_off < 0) | (b_off > 1)).any():
                continue                             # neighbor outside cell
            b = int((b_off * (1 << np.arange(dim))).sum())
            for mask in range(2 ** nb):
                if mask >> c & 1:
                    T[mask, o] += k_ref[a, b]
    return T


@dataclass
class LevelTopology:
    """Compact inputs for one level's device-side operator build; tensors
    on the forest's device."""

    level: int
    n: int                      # true dof count
    side: int                   # level lattice side (cells per axis)
    coords: torch.Tensor        # (n, dim) int16/int32 level-local node coords
    mask8: torch.Tensor         # (n,) uint8 adjacent-cell existence bits
    elim: torch.Tensor          # (n,) bool: interface | boundary (eliminated)
    iface: torch.Tensor         # (n,) bool: refinement-edge dofs
    boundary: torch.Tensor      # (n,) bool: domain-boundary dofs
    h: float                    # level cell size


def level_topology(forest: Forest, ld: LevelDofs, l: int) -> LevelTopology:
    """The compact level inputs (degree 1 only), on the forest's device."""
    if ld.degree != 1:
        raise ValueError("stencil operators are Q1-only")
    dim = forest.dim
    shift = forest.max_level - l
    coords = forest.nkey_to_coords(ld.keys, 1) >> shift    # level lattice
    side = forest.side(l)
    level_ijk, _ = forest.level_cells[l]
    cells = KeyIndex(forest.level_cell_key(l, level_ijk))
    corners = upload(corner_offsets(dim), coords.device)
    mask8 = torch.zeros(len(coords), dtype=torch.uint8, device=coords.device)
    for c in range(2 ** dim):
        cand = coords - corners[c]
        ok = ((cand >= 0) & (cand < side)).all(dim=1)
        key = forest.level_cell_key(l, torch.where(ok[:, None], cand, 0))
        present = ok & cells.contains(key)
        mask8 |= present.to(torch.uint8) << c
    ctype = torch.int16 if side + 2 < 2 ** 15 else torch.int32
    return LevelTopology(level=l, n=ld.n_dofs, side=int(side),
                         coords=coords.to(ctype), mask8=mask8,
                         elim=ld.interface | ld.boundary,
                         iface=ld.interface.clone(),
                         boundary=ld.boundary.clone(), h=float(forest.h(l)))


def topology_signature(t: LevelTopology) -> tuple:
    """Content key for cross-cycle reuse of device-built level operators:
    SHA-1 of one host copy of the compact arrays."""
    import hashlib
    h = hashlib.sha1()
    for a in (t.coords, t.mask8, t.elim, t.iface):
        h.update(np.ascontiguousarray(to_host(a)))
    return (t.level, t.n, t.side, h.hexdigest())


# ---------------------------------------------------------------------------
# device: node lookup
# ---------------------------------------------------------------------------


def _keys(coords: torch.Tensor, side: int) -> torch.Tensor:
    """Linear int64 key of lattice coords (..., dim); sorted node sets are
    sorted by this key (level dof order is key order)."""
    m = side + 1
    c = coords.to(torch.int64)
    key = c[..., 0]
    for d in range(1, c.shape[-1]):
        key = key * m + c[..., d]
    return key


def _lookup(keys: torch.Tensor, n: int, q: torch.Tensor) -> torch.Tensor:
    """Index of each query key among the first ``n`` (sorted) keys, or -1."""
    pos = torch.searchsorted(keys[:n].contiguous(), q)
    pc = pos.clamp(max=max(n - 1, 0))
    hit = (keys[pc] == q) & (pos < n)
    return torch.where(hit, pos, -1)


# ---------------------------------------------------------------------------
# device: level / interface operator build
# ---------------------------------------------------------------------------


def build_level_ops(coords, mask8, elim, iface, bnd, n, T, *, dim, side, h,
                    want_iface, dtype):
    """Device-side build of one level's operators from compact topology.

    Returns (cols, evals, inv_diag[, if_vals, ifT_vals]); cols and values
    are (3^dim, n_pad).  Semantics of coulomb_gmg_tpu/ops/stencil.py:
    eliminated rows/cols keep only the raw diagonal; the interface matrix
    keeps (i on edge, j off edge, neither on boundary); its transpose is
    evaluated at the reversed offset."""
    dev = coords.device
    n_pad = coords.shape[0]
    offs = upload(offset3(dim), dev)                             # (K3, dim)
    K3 = offs.shape[0]
    center = (K3 - 1) // 2
    scale = upload(np.asarray(float(h) ** (dim - 2)), dev, dtype)
    Td = T.to(dtype)
    elim, iface, bnd = elim.bool(), iface.bool(), bnd.bool()

    c64 = coords.to(torch.int64)
    keys = _keys(c64, side)
    nq = offs[:, None, :] + c64[None, :, :]                      # (K3, n_pad, dim)
    in_box = ((nq >= 0) & (nq <= side)).all(-1)
    idx = _lookup(keys, n, _keys(torch.where(in_box[..., None], nq, 0), side))
    valid = in_box & (idx >= 0)

    rows = torch.arange(n_pad, device=dev)
    row_ok = rows < n
    cols = torch.where(valid, idx, rows[None, :])                # self for padding
    m8 = mask8.to(torch.int64)
    zero = torch.zeros((), dtype=dtype, device=dev)
    raw = torch.where(valid, scale * Td.T[:, m8], zero)          # (K3, n_pad)

    elim_j = torch.where(valid, elim[cols], True)
    is_center = (torch.arange(K3, device=dev) == center)[:, None]
    keep = is_center | (~elim[None, :] & ~elim_j)
    evals = torch.where(keep & row_ok[None, :], raw, zero)

    diag = evals[center]
    inv_diag = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0),
                           torch.ones((), dtype=dtype, device=dev))
    cols32 = cols.to(torch.int32).contiguous()
    if not want_iface:
        return cols32, evals.contiguous(), inv_diag

    ifc_j = torch.where(valid, iface[cols], False)
    bnd_j = torch.where(valid, bnd[cols], True)
    keep_if = (iface[None, :] & ~ifc_j & ~bnd[None, :] & ~bnd_j
               & row_ok[None, :])
    if_vals = torch.where(keep_if, raw, zero)

    # transpose: entry (o, j) = A_if[i, j] with i = j + offs[o]: the RAW
    # stencil of i at the reversed offset, under the keep mask at (i, j)
    rev = (K3 - 1 - torch.arange(K3, device=dev))[:, None].expand(K3, n_pad)
    rawT = torch.where(valid, scale * Td[m8[cols], rev], zero)
    keep_ifT = (torch.where(valid, iface[cols], False) & ~iface[None, :]
                & ~torch.where(valid, bnd[cols], True) & ~bnd[None, :]
                & row_ok[None, :])
    ifT_vals = torch.where(keep_ifT, rawT, zero)
    return (cols32, evals.contiguous(), inv_diag, if_vals.contiguous(),
            ifT_vals.contiguous())


def build_prolongation_ops(coords_f, n_f, coords_c, n_c, *, dim, side_c,
                           dtype):
    """Q1 prolongation (rows = fine dofs, 2^dim slots) and restriction
    R = P^T (rows = coarse dofs, 3^dim slots) from coordinate parity."""
    dev = coords_f.device
    n_pad_f = coords_f.shape[0]
    n_pad_c = coords_c.shape[0]
    side_f = 2 * side_c
    keys_c = _keys(coords_c, side_c)
    keys_f = _keys(coords_f, side_f)
    zero = torch.zeros((), dtype=dtype, device=dev)
    half = torch.full((), 0.5, dtype=dtype, device=dev)

    # ---- P: (2^dim, n_pad_f)
    cf = coords_f.to(torch.int64)
    corners = upload(corner_offsets(dim), dev)                # (nbp, dim)
    odd = cf & 1
    base = cf >> 1
    m_coord = base[None] + corners[:, None, :] * odd[None]
    w_axis = torch.where(odd[None] == 1, half,
                         (corners[:, None, :] == 0).to(dtype))
    p_w = torch.prod(w_axis, dim=-1)                          # (nbp, n_pad_f)
    p_idx = _lookup(keys_c, n_c, _keys(m_coord, side_c))
    rows_f = torch.arange(n_pad_f, device=dev)
    ok = (p_idx >= 0) & (p_w != 0) & (rows_f < n_f)[None, :]
    p_cols = torch.where(ok, p_idx, 0)
    p_vals = torch.where(ok, p_w, zero)

    # ---- R = P^T: (3^dim, n_pad_c)
    offs = upload(offset3(dim), dev)
    cc = coords_c.to(torch.int64)
    fq = 2 * cc[None] + offs[:, None, :]
    in_box = ((fq >= 0) & (fq <= side_f)).all(-1)
    r_w = torch.prod(torch.where(offs == 0, torch.ones((), dtype=dtype,
                                                       device=dev), half),
                     dim=-1)                                   # (K3,)
    r_idx = _lookup(keys_f, n_f,
                    _keys(torch.where(in_box[..., None], fq, 0), side_f))
    rows_c = torch.arange(n_pad_c, device=dev)
    ok_r = in_box & (r_idx >= 0) & (rows_c < n_c)[None, :]
    r_cols = torch.where(ok_r, r_idx, 0)
    r_vals = torch.where(ok_r, r_w[:, None].expand_as(ok_r), zero)
    return (p_cols.to(torch.int32).contiguous(), p_vals.contiguous(),
            r_cols.to(torch.int32).contiguous(), r_vals.contiguous())


POWER_ITERS = 15          # the Chebyshev bound quality drives CG counts


def power_lmax_device(cols, evals, inv_diag, n: int):
    """lambda_max(D^{-1} A) by power iteration from the deterministic
    hash-based start of the JAX twin; returns a 0-dim tensor."""
    dev, dtype = evals.device, evals.dtype
    n_pad = cols.shape[1]
    i = torch.arange(n_pad, dtype=torch.int64, device=dev)
    h = ((i * 2654435761) & 0xFFFFFFFF) >> 8        # uint32 hash, < 2^24
    v = h.to(dtype) / float(2 ** 24) - 0.5
    v = torch.where(i < n, v, torch.zeros((), dtype=dtype, device=dev))
    v = v / torch.linalg.vector_norm(v)
    lam = torch.ones((), dtype=dtype, device=dev)
    for _ in range(POWER_ITERS):
        w = inv_diag * ell_mv(cols, evals, v)
        lam = torch.linalg.vector_norm(w)
        v = torch.where(lam > 0, w / torch.where(lam > 0, lam, 1.0), v)
    return lam
