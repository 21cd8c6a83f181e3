"""Host-pattern CSR with device data, applied through the ELL kernel.

Counterpart of coulomb_gmg_tpu/ops/spmv.py.  The JAX ``csr_matvec`` is a
gather and a segment scatter-add (``.at[rowids].add``); on CUDA a scatter
is atomic and its order of additions varies from run to run.  Here every
product is a gather: ``matvec`` and ``matvec_T`` run the ELL kernel
(ops/ell.py) on a sliced ELL of the matrix and one of its transpose, each
built once on the host (``utils/native.py:csr_to_sliced``) and kept on the
device with the matrix: a span ``ell.host_build`` of the run, the values
read back once (``device.py:read_back``).  Replaces Trilinos Epetra SpMV, the
workhorse of the reference's CG and V-cycle (src/step-50.cc:938-1017).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from coulomb_gmg_tpu_torch.device import read_back, upload
from coulomb_gmg_tpu_torch.ops.ell import SlicedELL, ell_mv
from coulomb_gmg_tpu_torch.utils.timer import span


def transpose_pattern(indptr: np.ndarray, indices: np.ndarray, n_cols: int):
    """(indptr_T, indices_T, perm) of the transpose: ``data_T =
    data[perm]``; rows of the transpose keep ascending columns."""
    counts = np.diff(indptr)
    rowids = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    perm = np.argsort(indices, kind="stable")
    indptr_t = np.zeros(n_cols + 1, np.int64)
    np.cumsum(np.bincount(indices, minlength=n_cols), out=indptr_t[1:])
    return indptr_t, rowids[perm], perm


@dataclass
class CSR:
    """Host-side pattern (``indptr``, ``indices``, ``rowids``) with the
    values ``data`` as a torch tensor on the device."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray     # (n_rows+1,)
    indices: np.ndarray    # (nnz,)
    rowids: np.ndarray     # (nnz,) expanded row ids (COO row index)
    data: torch.Tensor     # (nnz,) on the device
    _ells: dict = field(default_factory=dict, repr=False)
    _host: Optional[np.ndarray] = field(default=None, repr=False)

    @staticmethod
    def from_pattern(indptr, indices, data, n_cols: Optional[int] = None,
                     device=None) -> "CSR":
        """``data``: a tensor, or a numpy array put on ``device`` (and kept
        for the host-side conversions, which then copy nothing back)."""
        indptr = np.asarray(indptr, np.int64)
        n_rows = len(indptr) - 1
        rowids = np.repeat(np.arange(n_rows, dtype=np.int64),
                           np.diff(indptr))
        host = None
        if not isinstance(data, torch.Tensor):
            host = np.ascontiguousarray(data)
            data = upload(host, device)
        return CSR(n_rows=n_rows, n_cols=n_cols or n_rows, indptr=indptr,
                   indices=np.asarray(indices, np.int64), rowids=rowids,
                   data=data, _host=host)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def data_np(self) -> np.ndarray:
        """The values on the host, copied once (through pinned memory from
        a card: the device-assembled matrices' only read-back)."""
        if self._host is None:
            self._host = read_back(self.data.detach())
        return self._host

    def ell(self, n_pad: Optional[int] = None,
            dtype: Optional[torch.dtype] = None, transpose: bool = False):
        """(:class:`~coulomb_gmg_tpu_torch.ops.ell.Slices`, vals): the
        matrix (or its transpose) as a sliced ELL of ``n_pad`` rows on the
        data's device; ``n_pad`` (default: the row count) adds zero rows.
        Built on the host once per (n_pad, dtype, transpose) and kept, a
        span ``ell.host_build``."""
        dtype = dtype or self.data.dtype
        n_out = self.n_cols if transpose else self.n_rows
        n_pad = n_out if n_pad is None else n_pad
        key = (n_pad, dtype, transpose)
        if key not in self._ells:
            with span("ell.host_build"):
                data = self.data_np()
                indptr, indices = self.indptr, self.indices
                if transpose:
                    indptr, indices, perm = transpose_pattern(
                        indptr, indices, self.n_cols)
                    data = data[perm]
                e = SlicedELL.from_csr(indptr, indices, data,
                                       pad_rows_to=n_pad)
                self._ells[key] = e.device(self.data.device, dtype)
        return self._ells[key]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (the ELL kernel on the card)."""
        return ell_mv(*self.ell(), x)

    def matvec_T(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T x (the ELL kernel on the transpose's ELL)."""
        return ell_mv(*self.ell(transpose=True), x)

    def diagonal(self) -> torch.Tensor:
        """diag(A) on the device (rows without a diagonal entry: 0)."""
        sel = np.flatnonzero(self.rowids == self.indices)
        dev = self.data.device
        out = torch.zeros(self.n_rows, dtype=self.data.dtype, device=dev)
        out[upload(self.rowids[sel], dev)] = self.data[upload(sel, dev)]
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data_np(), self.indices, self.indptr),
                             shape=(self.n_rows, self.n_cols))
