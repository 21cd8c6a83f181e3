"""ELL sparse matrix-vector product in the transposed ``(K, n_rows)`` layout.

Counterpart of coulomb_gmg_tpu/ops/ell.py (the Pallas ``_ell_kernel``) and
of ``_ell_mv_t`` in coulomb_gmg_tpu/solver/tpu_gmg.py: ``y[i] = sum_k
vals[k, i] * x[cols[k, i]]``, padding slots holding value 0.  Every level,
interface, transfer and constraint-expansion apply of the solve goes through
:func:`ell_mv`; on a CUDA tensor that is the hand kernel in
``csrc/ell_spmv.cu`` (unrolled for K = 27, streaming loads of ``cols`` and
``vals``; the same FMA chain in k order, so the same bits, for every K).
"""

from __future__ import annotations

import ctypes

import torch

from coulomb_gmg_tpu_torch import kernels

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p]
_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}


def ell_mv_plain(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, multiply, reduce over K."""
    return (vals * x[cols]).sum(0)


def ell_mv_cuda(cols: torch.Tensor, vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no fall back)."""
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise TypeError(f"ell_mv: unsupported dtypes {vals.dtype}/{x.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_mv: cols must be int32, got {cols.dtype}")
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"ell_mv: shapes cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    if not (cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_mv_cuda: operands must be contiguous")
    if not (cols.is_cuda and vals.is_cuda and x.is_cuda):
        raise ValueError("ell_mv_cuda: every operand must be on the card")
    K, n = cols.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    lib = kernels.library("ell_spmv", {f: _SIG for f in _FN.values()})
    err = getattr(lib, _FN[x.dtype])(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), K, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "ell_spmv")
    ell_mv.launches += 1
    return y


def ell_mv(cols: torch.Tensor, vals: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for an ELL operator; the CUDA kernel on the card, the
    plain version only for CPU tensors."""
    if x.device.type == "cpu":
        return ell_mv_plain(cols, vals, x)
    return ell_mv_cuda(cols, vals, x)


ell_mv.launches = 0       # kernel launches (CUDA path only)
