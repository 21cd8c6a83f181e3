"""The ELL sparse matrix-vector product (``ops/ell.py:ell_mv_cuda``, both
layouts): one FMA, its value and a 4-byte column per nonzero; x read, y
written."""

import torch

from gmg_bench.metrics._roofline import bound_s as _bound

MODULE = "coulomb_gmg_tpu_torch.ops.ell"
LAUNCHER = "ell_mv_cuda"
DEVICE = ("ell_spmv_kernel", "ell_sliced_kernel")


def bound_s(args, kw) -> float:
    cols, vals, x = args
    nnz = int(torch.count_nonzero(vals))
    rows = cols.n_rows if hasattr(cols, "n_rows") else cols.shape[-1]
    return _bound(2 * nnz, nnz * (4 + vals.element_size())
                  + (x.numel() + rows) * x.element_size())
