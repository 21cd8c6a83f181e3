"""Charge density at the RHS quadrature points.

Counterpart of coulomb_gmg_tpu/ops/pallas_density.py (the Pallas
``_density_kernel`` behind ``density_pallas_cells``) and of
coulomb_gmg_tpu/ops/density.py.  The brute-force branch runs when the
reference's "Flag for RHS evaluation optimization" is off: every atom at
every quadrature point,

    rho~(x) = 4 pi / (r_c^3 pi^1.5) * sum_a q_a exp(-|x - X_a|^2 / r_c^2)

(src/step-50.cc:509-575 without the locality index).  :func:`dense_density`
is the hand kernel in ``csrc/dense_density.cu`` on the card, at every atom
count, and :func:`dense_density_plain` for CPU tensors.  The kernel skips
the pairs whose float32 ``expf(-r^2 / r_c^2)`` is exactly +0, those with
``r^2 / r_c^2 >= ZERO_EXP``, by box tests against :func:`zero_r2`; a term
that is +0 leaves the float32 sum unchanged, so the skip changes no bit.
The TPU path's far-away padding points, 512-wide tiles and 2M-point
dispatch blocks are not carried over.

:func:`compute_density` is the JAX module's mask, list and brute-force
branches (float64 runs take their density from it, never from the float32
kernels), with :func:`atom_masks`, :func:`masks_to_lists` and
:func:`cell_quad_points`.  On the card a density over atom lists or masks
is the hand kernel ``csrc/list_density.cu`` (:func:`list_density`), in
the run's float type, over the compact lists of ops/neighbors.py:
``AtomLists``; the plain branches run only for CPU tensors.  Like the JAX
jnp code both evaluate the Gaussian per axis on the tensor-product rule
(dim * n1 exponentials per (cell, atom) entry, recombined into the n1^dim
points).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from typing import Optional

from coulomb_gmg_tpu_torch.device import upload
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.ops.neighbors import AtomLists
from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.utils.timer import count

# The smallest float32 t from which the card's float32 expf(-t) is +0 for
# every float32 t' >= t: the IEEE underflow point, ln 2^-150.  The expf of
# csrc/dense_density.cu returns subnormals down to 2^-149 (at the float32
# just below); tests/test_torch_cuda.py sweeps every float32 in
# [ZERO_EXP, 1e4] on the card.
ZERO_EXP = 103.97208404541016
_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_float,
                                ctypes.c_void_p, ctypes.c_void_p]
_SIG_EXP = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
_FNS = {"dense_density_f32": _SIG, "expf_neg_f32": _SIG_EXP}
_SIG_LIST = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
             + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 2)
_LIST_FNS = {
    "list_density_f64": _SIG_LIST + [ctypes.c_double] * 2 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p],
    "list_density_f32": _SIG_LIST + [ctypes.c_float] * 2 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p]}
# (point, atom) pairs per chunk of the plain version: small on the CPU
# (tests), large on the card (its comparison with the kernel)
_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 25}


def pack_atoms(positions, charges, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Atoms as one contiguous ``(A, 4)`` tensor of rows ``(x, y, z, q)``
    (coordinates past the positions' dim zero): the float4 layout the
    kernels stage in shared memory."""
    positions = np.asarray(positions, np.float64)
    a = np.zeros((len(positions), 4), np.float64)
    a[:, :positions.shape[-1]] = positions
    a[:, 3] = np.asarray(charges, np.float64)
    return upload(a, device, dtype).contiguous()


def dense_density_plain(lower: torch.Tensor, h: torch.Tensor,
                        pref: torch.Tensor, atoms: torch.Tensor, *,
                        inv_rc2: float, scale: float,
                        n_out: int) -> torch.Tensor:
    """Plain PyTorch version in the tensors' own dtype, chunked over cells.
    Returns ``(n_out, n_q)``; rows past ``len(lower)`` are zero."""
    C, n_q = lower.shape[0], pref.shape[0]
    X, q = atoms[:, :3], atoms[:, 3]
    out = torch.zeros(n_out, n_q, dtype=lower.dtype, device=lower.device)
    step = max(1, _PAIRS[lower.device.type]
               // max(n_q * atoms.shape[0], 1))
    for s in range(0, C, step):
        e = min(s + step, C)
        pts = lower[s:e, None, :] + h[s:e, None, None] * pref
        d = pts[:, :, None, :] - X                      # (c, n_q, A, 3)
        r2 = (d * d).sum(-1)
        out[s:e] = (torch.exp(-r2 * inv_rc2) * q).sum(-1) * scale
    return out


def zero_r2(r_c: float) -> float:
    """The kernel's skip test ``box distance^2 >= zero_r2``: ``ZERO_EXP
    r_c^2`` raised by 1e-4 so that every skipped pair's computed
    ``r^2 * inv_rc2`` is ``>= ZERO_EXP``."""
    return ZERO_EXP * r_c * r_c * (1.0 + 1e-4)


def dense_density_cuda(lower: torch.Tensor, h: torch.Tensor,
                       pref: torch.Tensor, atoms: torch.Tensor, *,
                       inv_rc2: float, scale: float, n_out: int,
                       skip_r2: float | None = None,
                       pairs: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fall back).

    ``skip_r2`` is the kernel's skip distance^2, :func:`zero_r2` of the
    ``r_c`` of ``inv_rc2`` by default; ``inf`` evaluates every pair.  If
    ``pairs`` (one int64 on the card) is given, the kernel adds to it the
    (point, atom) pairs it evaluated."""
    ops = (lower, h, pref, atoms)
    if not all(t.dtype == torch.float32 for t in ops):
        raise TypeError("dense_density_cuda: float32 only")
    C, n_q = lower.shape[0], pref.shape[0]
    if (lower.shape != (C, 3) or h.shape != (C,) or pref.shape != (n_q, 3)
            or atoms.dim() != 2 or atoms.shape[1] != 4 or n_out < C):
        raise ValueError("dense_density_cuda: inconsistent shapes")
    if not all(t.is_contiguous() for t in ops) or atoms.data_ptr() % 16:
        raise ValueError("dense_density_cuda: operands must be contiguous, "
                         "atoms 16-byte aligned")
    if pairs is not None and not (pairs.is_cuda and pairs.numel() == 1
                                  and pairs.dtype == torch.int64):
        raise ValueError("dense_density_cuda: pairs must be one int64 on "
                         "the card")
    if skip_r2 is None:
        skip_r2 = zero_r2(inv_rc2 ** -0.5)
    if not skip_r2 > 0:
        raise ValueError(f"dense_density_cuda: skip_r2 {skip_r2} is not > 0")
    if not all(t.is_cuda for t in ops):
        raise ValueError("dense_density_cuda: operands must be on the card")
    n_atoms = atoms.shape[0]
    out = torch.empty(n_out, n_q, dtype=torch.float32, device=lower.device)
    gbox = torch.empty((n_atoms + 31) // 32, 8, dtype=torch.float32,
                       device=lower.device)         # per 32-atom group box
    lib = kernels.library("dense_density", _FNS)
    kernels.launch(
        lib.dense_density_f32, lower.device, "dense_density",
        lower.data_ptr(), h.data_ptr(), pref.data_ptr(), atoms.data_ptr(),
        gbox.data_ptr(), out.data_ptr(), C, n_out, n_q, n_atoms, inv_rc2,
        scale, skip_r2, None if pairs is None else pairs.data_ptr())
    dense_density.launches += 1
    return out


def dense_density(lower, h, pref, atoms, **kw) -> torch.Tensor:
    """Brute-force density per (cell, reference point): the CUDA kernel on
    the card, the plain version only for CPU tensors."""
    if lower.device.type == "cpu":
        return dense_density_plain(lower, h, pref, atoms, **kw)
    return dense_density_cuda(lower, h, pref, atoms, **kw)


dense_density.launches = 0    # kernel launches (CUDA path only)


def expf_neg_cuda(t: torch.Tensor) -> torch.Tensor:
    """``expf(-t)`` by the kernel library's own ``expf`` (the one the
    density kernel inlines), for the sweep that checks :data:`ZERO_EXP`."""
    if not (t.is_cuda and t.is_contiguous() and t.dtype == torch.float32):
        raise ValueError("expf_neg_cuda: a contiguous float32 tensor on the "
                         "card")
    out = torch.empty_like(t)
    lib = kernels.library("dense_density", _FNS)
    kernels.launch(lib.expf_neg_f32, t.device, "expf_neg", t.data_ptr(),
                   out.data_ptr(), t.numel())
    return out


def density_operands(forest: Forest, points_ref, positions, charges,
                     r_c: float, device) -> tuple:
    """Float32 device operands and constants of :func:`dense_density`:
    ``(args, kwargs)``.  Constants are rounded to float32 up front, as the
    TPU kernel saw them."""
    def put(a):
        return upload(np.ascontiguousarray(a, np.float32), device)

    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)     # as ops/density.py
    args = (put(forest.cell_lower()), put(forest.cell_h()), put(points_ref),
            pack_atoms(positions, charges, device))
    kw = dict(inv_rc2=float(np.float32(1.0 / (r_c * r_c))),
              scale=float(np.float32(const)))
    return args, kw


def density_bruteforce(forest: Forest, points_ref, positions, charges,
                       r_c: float, device, c_pad: int) -> torch.Tensor:
    """rho~ per (cell, reference quadrature point) over all atoms, with the
    4*pi normalization (src/step-50.cc:553-560), as a ``(c_pad, n_q)``
    float32 tensor on ``device``; rows past ``n_cells`` are exactly zero
    (the contract of StencilGMG.assemble_rhs).  Counts its (point, atom)
    pairs in the run's counter ``density_pairs``."""
    args, kw = density_operands(forest, points_ref, positions, charges, r_c,
                                device)
    count("density_pairs", forest.n_cells * len(points_ref) * len(charges))
    return dense_density(*args, n_out=int(c_pad), **kw)


# ---------------------------------------------------------------------------
# mask, list and brute-force branches (plain PyTorch, any float dtype)
# ---------------------------------------------------------------------------

def cell_quad_points(forest: Forest, points_ref: np.ndarray,
                     cells: Optional[np.ndarray] = None) -> np.ndarray:
    """Physical quadrature points (n_cells, n_q, dim) for reference points
    (n_q, dim), float64 numpy."""
    lower = forest.cell_lower(cells)
    h = forest.cell_h(cells)
    return lower[:, None, :] + h[:, None, None] * points_ref[None, :, :]


def atom_masks(forest: Forest, positions: np.ndarray, cutoff: float,
               device, chunk: int = 65536) -> np.ndarray:
    """(n_cells, n_atoms) bool numpy: atom within ``cutoff`` of ANY cell
    vertex (src/step-50.cc:273-283), computed in float64 on ``device``.
    The minimum over the 2^dim corners factorizes per axis."""
    dev = torch.device(device)
    pos = upload(np.asarray(positions, np.float64), dev)
    lower = upload(forest.cell_lower(), dev)
    h = upload(forest.cell_h(), dev)
    out = []
    for s in range(0, forest.n_cells, chunk):
        a = pos[None, :, :] - lower[s:s + chunk, None, :]
        b = a - h[s:s + chunk, None, None]
        d2 = torch.minimum(a * a, b * b).sum(-1)
        out.append((d2 < cutoff * cutoff).cpu().numpy())
    if not out:
        return np.zeros((0, len(positions)), bool)
    return np.concatenate(out, axis=0)


def masks_to_lists(mask: np.ndarray, pad_to: Optional[int] = None):
    """Dense (cells, atoms) mask -> padded per-cell atom lists (n_cells, K)
    int32 with -1 padding, and the per-cell counts."""
    counts = mask.sum(axis=1)
    K = int(counts.max()) if pad_to is None else pad_to
    lists = np.full((mask.shape[0], max(K, 1)), -1, dtype=np.int32)
    rows, cols = np.nonzero(mask)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    lists[rows, np.arange(len(rows)) - first[rows]] = cols
    return lists, counts


def _tensor_rule_1d(points_ref: np.ndarray, dim: int):
    """1-D abscissae if ``points_ref`` is their tensor-product grid (axis 0
    slowest, axis dim-1 fastest), else None."""
    n_q = len(points_ref)
    n1 = int(round(n_q ** (1.0 / dim)))
    if n1 ** dim != n_q:
        return None
    grids = np.stack(np.meshgrid(*([np.arange(n1)] * dim), indexing="ij"),
                     axis=-1).reshape(-1, dim)
    x1 = points_ref[:n1, dim - 1]
    if np.allclose(x1[grids], points_ref, atol=1e-14):
        return x1
    return None


def _sep_rho(E: torch.Tensor, qa: torch.Tensor) -> torch.Tensor:
    """E: (C, n1, K, dim) per-axis Gaussian factors, qa (C, K) charges
    (zero for padding).  Returns the unnormalized (C, n1^dim) sums."""
    C, n1 = E.shape[0], E.shape[1]
    dim = E.shape[-1]
    if dim == 3:
        T = (E[:, :, None, :, 1] * E[:, None, :, :, 2]).reshape(C, n1 * n1,
                                                               -1)
    elif dim == 2:
        T = E[..., 1]
    else:
        return torch.einsum("cik,ck->ci", E[..., 0], qa)
    T = T * qa[:, None, :]
    return torch.einsum("cik,cjk->cij", E[..., 0], T).reshape(C, n1 ** dim)


def _rho_block(lower, h, pref, x1, pos, qa, r_c: float) -> torch.Tensor:
    """Unnormalized density of a block of cells over per-cell atom sets:
    ``pos`` (C, K, dim) or (K, dim), ``qa`` (C, K)."""
    if x1 is not None:
        xq = lower[:, None, :] + h[:, None, None] * x1[None, :, None]
        P = pos if pos.dim() == 3 else pos[None]
        d = xq[:, :, None, :] - P[:, None, :, :]        # (C, n1, K, dim)
        return _sep_rho(torch.exp(-(d * d) / (r_c * r_c)), qa)
    pts = lower[:, None, :] + h[:, None, None] * pref[None]
    P = pos if pos.dim() == 3 else pos[None]
    d = pts[:, :, None, :] - P[:, None, :, :]           # (C, n_q, K, dim)
    r2 = (d * d).sum(-1)
    return (torch.exp(-r2 / (r_c * r_c)) * qa[:, None, :]).sum(-1)


def _list_operands(lists: AtomLists, dev: torch.device):
    """``ptr``, ``atoms`` and ``home`` on ``dev`` in one pinned copy of
    int32 words, counted as one upload."""
    n_p, n_a = 2 * len(lists.ptr), len(lists.atoms)
    host = torch.empty(n_p + n_a + lists.n_cells, dtype=torch.int32,
                       pin_memory=True)
    h = host.numpy()
    h[:n_p] = np.ascontiguousarray(lists.ptr, np.int64).view(np.int32)
    h[n_p:n_p + n_a] = lists.atoms
    h[n_p + n_a:] = lists.home
    count("uploads")
    count("upload_bytes", h.nbytes)
    buf = host.to(dev, non_blocking=True)
    return buf[:n_p].view(torch.int64), buf[n_p:n_p + n_a], buf[n_p + n_a:]


def list_operands(forest: Forest, points_ref: np.ndarray, positions,
                  charges, r_c: float, lists: AtomLists, device,
                  dtype: torch.dtype = torch.float64,
                  cells: Optional[range] = None,
                  n_out: Optional[int] = None) -> tuple:
    """The card operands of :func:`list_density_cuda` for the cells
    ``cells`` (a range, default all; ``lists`` holds the rows of every
    cell): ``(args, kwargs)``.  ``ptr``, ``atoms`` and ``home`` go up in
    one pinned copy; the cells' corners are computed on the card from the
    forest's ``level`` and ``ijk``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("list_density: the kernel runs on the card")
    if dtype not in (torch.float64, torch.float32):
        raise TypeError("list_density: float64 or float32")
    dim, n_q = forest.dim, len(points_ref)
    x1 = _tensor_rule_1d(np.asarray(points_ref, np.float64), dim)
    if x1 is None:
        raise ValueError(f"list_density: {n_q} points are no tensor-product "
                         "rule")
    c0, c1 = (0, forest.n_cells) if cells is None else (cells.start,
                                                        cells.stop)
    lists = lists.select(cells)
    n_rows = c1 - c0
    n_out = n_rows if n_out is None else int(n_out)
    if lists.n_cells != n_rows or n_out < n_rows:
        raise ValueError("list_density: inconsistent rows")
    ptr, atoms, home = _list_operands(lists, dev)
    args = (ptr, atoms, home, forest.level_t[c0:c1].to(dev),
            forest.ijk_t[c0:c1].to(dev).contiguous(),
            upload(np.ascontiguousarray(x1), dev, dtype),
            pack_atoms(np.reshape(positions, (-1, dim)), charges, dev, dtype))
    lo = np.zeros(3)
    lo[:dim] = forest.lower
    return args, dict(dim=dim, lower=tuple(map(float, lo)),
                      h0=float(forest.h0), rc2=float(r_c * r_c),
                      scale=4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5),
                      n_rows=n_rows, n_out=n_out)


def list_density_cuda(ptr, atoms, home, level, ijk, x1, apos, *, dim: int,
                      lower: tuple, h0: float, rc2: float, scale: float,
                      n_rows: int, n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: ``(n_out, n1^dim)``
    in the atoms' float type (``apos``, float64 or float32)."""
    dev = apos.device
    out = torch.empty(n_out, x1.numel() ** dim, dtype=apos.dtype,
                      device=dev)
    lib = kernels.library("list_density", _LIST_FNS)
    kernels.launch(
        lib.list_density_f64 if apos.dtype == torch.float64
        else lib.list_density_f32, dev, "list_density", ptr.data_ptr(),
        atoms.data_ptr(), home.data_ptr(), level.data_ptr(), ijk.data_ptr(),
        dim, x1.numel(), *lower, h0, x1.data_ptr(), apos.data_ptr(), rc2,
        scale, out.data_ptr(), n_rows, n_out)
    return out


def list_density(forest: Forest, points_ref: np.ndarray, positions,
                 charges, r_c: float, lists: AtomLists, device,
                 dtype: torch.dtype = torch.float64,
                 cells: Optional[range] = None,
                 n_out: Optional[int] = None) -> torch.Tensor:
    """rho~ per (cell, reference point) over each cell's atom list by the
    CUDA kernel ``csrc/list_density.cu``: ``(n_out, n_q)`` in ``dtype``
    (float64 or float32) on the card, one row for each cell of ``cells``
    (a range, default all; ``lists`` holds the rows of every cell), rows
    past them exactly zero.  The lists travel to the card for this call
    only.  Counts the (cell, atom) entries it evaluates in the run's
    counter ``density_list_entries``."""
    args, kw = list_operands(forest, points_ref, positions, charges, r_c,
                             lists, device, dtype, cells, n_out)
    count("density_list_entries", int(lists.select(cells).counts.sum()))
    out = list_density_cuda(*args, **kw)
    list_density.launches += 1
    return out


list_density.launches = 0    # kernel launches


def compute_density(forest: Forest, points_ref: np.ndarray, positions,
                    charges, r_c: float, device, mask=None, lists=None,
                    dtype: torch.dtype = torch.float64,
                    pairs_per_chunk: int = 1 << 24,
                    cells: Optional[range] = None,
                    n_out: Optional[int] = None) -> torch.Tensor:
    """rho~ per (cell, reference quadrature point), ``(n_cells, n_q)`` on
    ``device``: over each cell's atom list (``lists``: an ``AtomLists`` or
    padded (n_cells, K) lists, -1 padded), its mask row (``mask``), or
    every atom.  Cells with an empty locality set are exactly zero.
    ``cells`` (a range of cell indices, default all) restricts it to those
    cells, one row each: a shard's own block (parallel/spmd.py); ``n_out``
    (default one row a cell) adds zero rows after them.

    On the card, lists and masks go to :func:`list_density` (the kernel);
    on the CPU the plain branches run, list cells grouped by list length
    (classes 8, 32, 128, ...) so that short lists are not padded to the
    longest, as in coulomb_gmg_tpu/ops/density.py:compute_density."""
    dev = torch.device(device)
    if dev.type == "cuda" and (lists is not None or mask is not None):
        if not isinstance(lists, AtomLists):
            lists = (AtomLists.from_mask(mask) if lists is None
                     else AtomLists.from_padded(lists))
        return list_density(forest, points_ref, positions, charges, r_c,
                            lists, dev, dtype, cells=cells, n_out=n_out)
    if isinstance(lists, AtomLists):
        lists = lists.padded()
    n_q, dim = len(points_ref), forest.dim
    sel = np.arange(forest.n_cells) if cells is None else \
        np.arange(cells.start, cells.stop)
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
    put = lambda a: upload(np.ascontiguousarray(a), dev, dtype)
    pos = put(np.asarray(positions, np.float64).reshape(-1, dim))
    q = put(np.asarray(charges, np.float64))
    x1 = _tensor_rule_1d(np.asarray(points_ref, np.float64), dim)
    x1 = put(x1) if x1 is not None else None
    pref = put(points_ref)
    out = torch.zeros(len(sel) if n_out is None else n_out, n_q,
                      dtype=dtype, device=dev)

    def run(rows, width, qa_of, pos_of):
        n1 = n_q if x1 is None else x1.numel()
        step = max(1, pairs_per_chunk // max(n1 * width * dim, 1))
        lower = put(forest.cell_lower(sel[rows]))
        h = put(forest.cell_h(sel[rows]))
        for s in range(0, len(rows), step):
            e = min(s + step, len(rows))
            rho = _rho_block(lower[s:e], h[s:e], pref, x1, pos_of(s, e),
                             qa_of(s, e), r_c)
            out[upload(rows[s:e], dev)] = const * rho

    if lists is not None:
        lists = lists[sel]
        counts = (lists >= 0).sum(axis=1)
        lo, kclass = 1, 8
        while lo <= lists.shape[1]:
            hi = min(kclass, lists.shape[1])
            rows = np.where((counts >= lo) & (counts <= hi))[0]
            if len(rows):
                li = upload(np.ascontiguousarray(lists[rows][:, :hi]), dev)
                safe = li.clamp(min=0).long()
                qa = torch.where(li >= 0, q[safe], 0.0)
                run(rows, hi, lambda s, e: qa[s:e],
                    lambda s, e: pos[safe[s:e]])
            lo = hi + 1
            kclass *= 4
        return out
    if mask is not None:
        mask = mask[sel]
        rows = np.where(mask.any(axis=1))[0]
        mk = upload(np.ascontiguousarray(mask[rows]), dev)
        run(rows, len(q), lambda s, e: q[None, :] * mk[s:e],
            lambda s, e: pos)
        return out
    rows = np.arange(len(sel))
    run(rows, len(q), lambda s, e: q[None, :].expand(e - s, -1),
        lambda s, e: pos)
    return out
