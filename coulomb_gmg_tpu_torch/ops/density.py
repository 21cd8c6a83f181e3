"""Brute-force charge density at the RHS quadrature points.

Counterpart of coulomb_gmg_tpu/ops/pallas_density.py (the Pallas
``_density_kernel`` behind ``density_pallas_cells``) and of the brute-force
branch of coulomb_gmg_tpu/ops/density.py:compute_density, which runs when
the reference's "Flag for RHS evaluation optimization" is off: every atom
at every quadrature point,

    rho~(x) = 4 pi / (r_c^3 pi^1.5) * sum_a q_a exp(-|x - X_a|^2 / r_c^2)

(src/step-50.cc:509-575 without the locality index).  :func:`dense_density`
is the hand kernel in ``csrc/dense_density.cu`` on the card, at every atom
count, and :func:`dense_density_plain` for CPU tensors.  The kernel skips
the pairs whose float32 ``expf(-r^2 / r_c^2)`` is exactly +0, those with
``r^2 / r_c^2 >= ZERO_EXP``, by box tests against :func:`zero_r2`; a term
that is +0 leaves the float32 sum unchanged, so the skip changes no bit.
The TPU path's far-away padding points, 512-wide tiles and 2M-point
dispatch blocks are not carried over.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch import kernels

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
# (point, atom) pairs per chunk of the plain version: small on the CPU
# (tests), large on the card (its comparison with the kernel)
_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 25}


def pack_atoms(positions, charges, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Atoms as one contiguous ``(A, 4)`` tensor of rows ``(x, y, z, q)``:
    the float4 layout the kernels stage in shared memory."""
    a = np.zeros((len(positions), 4), np.float64)
    a[:, :3] = np.asarray(positions, np.float64)
    a[:, 3] = np.asarray(charges, np.float64)
    return torch.from_numpy(a).to(device=device, dtype=dtype).contiguous()


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
    err = lib.dense_density_f32(
        lower.data_ptr(), h.data_ptr(), pref.data_ptr(), atoms.data_ptr(),
        gbox.data_ptr(), out.data_ptr(), C, n_out, n_q, n_atoms, inv_rc2,
        scale, skip_r2, None if pairs is None else pairs.data_ptr(),
        torch.cuda.current_stream(lower.device).cuda_stream)
    kernels.check(err, "dense_density")
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
    kernels.check(lib.expf_neg_f32(
        t.data_ptr(), out.data_ptr(), t.numel(),
        torch.cuda.current_stream(t.device).cuda_stream), "expf_neg")
    return out


def density_operands(forest: Forest, points_ref, positions, charges,
                     r_c: float, device) -> tuple:
    """Float32 device operands and constants of :func:`dense_density`:
    ``(args, kwargs)``.  Constants are rounded to float32 up front, as the
    TPU kernel saw them."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

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
    (the contract of StencilGMG.assemble_rhs)."""
    args, kw = density_operands(forest, points_ref, positions, charges, r_c,
                                device)
    return dense_density(*args, n_out=int(c_pad), **kw)
