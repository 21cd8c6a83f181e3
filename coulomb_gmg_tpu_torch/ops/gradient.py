"""Gradient of the exact potential at many points (FE-error postprocess).

Counterpart of coulomb_gmg_tpu/ops/pallas_gradient.py (the Pallas
``_grad_kernel``): for points ``(P, 3)`` and atoms packed as ``(A, 4)``
rows ``(x, y, z, q)`` (ops/density.py:pack_atoms),

    grad(x) = sum_a W_a (x - X_a),
    W_a = q_a (2 r e^{-(r/r_c)^2} / (sqrt(pi) r_c) - erf(r/r_c)) / r^3,

zero where ``r^2 < 1e-14``.  :func:`exact_gradient` is the hand kernel in
``csrc/exact_gradient.cu`` on the card and :func:`exact_gradient_plain` for
CPU tensors.  The kernel gives a pair with ``r / r_c >= FAR`` the far path
``W_a = -q_a / r^3``: in float32 the bracket is exactly -1 there
(tests/test_torch_gradient.py sweeps it), so both paths give the same
bits.  Both use direct differences ``x - X_a``; the TPU's
``|x|^2 + |X|^2 - 2 x.X`` form and its coordinate centring are not carried
over.
"""

from __future__ import annotations

import ctypes
import math

import torch

from coulomb_gmg_tpu_torch import kernels
from coulomb_gmg_tpu_torch.utils.timer import count

FAR = 4.5                 # r / r_c from which the bracket is exactly -1
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_float, ctypes.c_float,
                                ctypes.c_float, ctypes.c_void_p]
# (point, atom) pairs per chunk of the plain version: small on the CPU
# (tests), large on the card (its float64 run is the FE-error oracle)
_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 25}


def exact_gradient_plain(points: torch.Tensor, atoms: torch.Tensor,
                         r_c: float) -> torch.Tensor:
    """Plain PyTorch version in the tensors' own dtype, chunked over points
    to bound the ``(chunk, A, 3)`` intermediates.  Returns ``(P, 3)``."""
    P, A = points.shape[0], atoms.shape[0]
    X, q = atoms[:, :3], atoms[:, 3]
    c2 = 2.0 / (math.sqrt(math.pi) * r_c)
    out = torch.empty_like(points)
    step = max(1, _PAIRS[points.device.type] // max(A, 1))
    for s in range(0, P, step):
        d = points[s:s + step, None, :] - X[None]         # (c, A, 3)
        r2 = (d * d).sum(-1)
        near = r2 < 1e-14
        ir = torch.rsqrt(torch.where(near, torch.ones_like(r2), r2))
        r = r2 * ir
        rq = r / r_c
        w = q * (c2 * r * torch.exp(-rq * rq) - torch.special.erf(rq)) \
            * ir * ir * ir
        w = torch.where(near, torch.zeros_like(w), w)
        out[s:s + step] = (w[..., None] * d).sum(1)
    return out


def far_r2(r_c: float) -> float:
    """The kernel's far test ``r^2 >= far_r2``: ``(FAR r_c)^2`` raised by
    1e-4 so that the kernel's computed ``r / r_c`` is ``>= FAR`` there."""
    return (FAR * r_c) ** 2 * (1.0 + 1e-4)


def exact_gradient_cuda(points: torch.Tensor, atoms: torch.Tensor,
                        r_c: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fall back)."""
    if not (points.is_cuda and atoms.is_cuda):
        raise ValueError("exact_gradient_cuda: operands must be on the card")
    if points.dtype != torch.float32 or atoms.dtype != torch.float32:
        raise TypeError(f"exact_gradient_cuda: float32 only, got "
                        f"{points.dtype}/{atoms.dtype}")
    if (points.dim() != 2 or points.shape[1] != 3 or atoms.dim() != 2
            or atoms.shape[1] != 4):
        raise ValueError(f"exact_gradient_cuda: shapes points "
                         f"{tuple(points.shape)}, atoms {tuple(atoms.shape)}")
    if not (points.is_contiguous() and atoms.is_contiguous()
            and atoms.data_ptr() % 16 == 0):
        raise ValueError("exact_gradient_cuda: operands must be contiguous, "
                         "atoms 16-byte aligned")
    out = torch.empty_like(points)
    lib = kernels.library("exact_gradient", {"exact_gradient_f32": _SIG})
    kernels.launch(
        lib.exact_gradient_f32, points.device, "exact_gradient",
        points.data_ptr(), atoms.data_ptr(), out.data_ptr(), points.shape[0],
        atoms.shape[0], 1.0 / r_c, 2.0 / (math.sqrt(math.pi) * r_c),
        far_r2(r_c))
    exact_gradient.launches += 1
    return out


def exact_gradient(points: torch.Tensor, atoms: torch.Tensor,
                   r_c: float) -> torch.Tensor:
    """Exact-solution gradient at ``points``: the CUDA kernel on the card,
    the plain version only for CPU tensors.  Counts its (point, atom) pairs
    in the run's counter ``gradient_pairs``."""
    count("gradient_pairs", points.shape[0] * atoms.shape[0])
    if points.device.type == "cpu":
        return exact_gradient_plain(points, atoms, r_c)
    return exact_gradient_cuda(points, atoms, r_c)


exact_gradient.launches = 0     # kernel launches (CUDA path only)
