"""The work that the benchmark's file of the SSOR sweep
(gmg_bench/kernels/ssor_sweep.py) counts for one application, on a
hand-built 6-row level matrix, against a count written out here."""

import pytest
import torch

from gmg_bench import cells
from gmg_bench.metrics import _roofline as R

# rows and their columns; the diagonal in every row
ROWS = [[0, 1], [0, 1, 2], [1, 2, 3, 5], [2, 3], [4, 5], [2, 4, 5]]


def operands(dtype):
    indptr = torch.tensor([0, 2, 5, 9, 11, 13, 16], dtype=torch.int32)
    indices = torch.tensor([c for r in ROWS for c in r], dtype=torch.int32)
    vals = torch.linspace(1.0, 2.0, 16, dtype=dtype)
    diag = torch.full((6,), 4.0, dtype=dtype)
    r = torch.ones(6, dtype=dtype)
    state = [torch.zeros(6, dtype=torch.float64) for _ in range(3)]
    return (indptr, indices, vals, diag, r, 0.5, *state,
            torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("dtype, value_bytes", [(torch.float64, 8),
                                                (torch.float32, 4)])
def test_one_application_counts_its_sweeps(monkeypatch, dtype, value_bytes):
    k = cells.kernels()["ssor_sweep"]
    assert (k.MODULE, k.LAUNCHER) == ("coulomb_gmg_tpu_torch.ops.smoothers",
                                      "ssor_sweep")
    assert k.DEVICE == ("ssor_forward", "ssor_backward")
    seen = []
    monkeypatch.setattr(k, "_bound", lambda ops, b: seen.append((ops, b)))
    k.bound_s(operands(dtype), {})
    # 16 nonzeros: 5 below the diagonal, 6 on it, 5 above.  FMAs: 5
    # (forward) + 16 (the residual) + 5 (backward) = 26, 2 operations
    # each; 5 a row for the differences, divisions and y1 + z; float64
    # arithmetic counted twice: 2 (2 x 26 + 5 x 6) = 164
    ops = 164
    # indptr 7 x 4; indices 16 x 4; values 16; diagonal, defect and
    # result 6 each
    n_bytes = 7 * 4 + 16 * 4 + (16 + 3 * 6) * value_bytes
    assert seen == [(ops, n_bytes)]
    monkeypatch.undo()
    assert k.bound_s(operands(dtype), {}) == pytest.approx(
        max(ops / R.PEAK_FP32, n_bytes / R.PEAK_BYTES))


def test_the_launch_log_wraps_the_sweep_only_where_that_is_safe():
    """The program's launcher is wrapped; a launcher that looks itself up
    by its own name (as ``ssor_sweep`` once did to count its launches)
    would call the wrapper's missing attribute, so there the file names
    ``make_ssor``, which the program never calls by the module's name."""
    from types import SimpleNamespace

    from coulomb_gmg_tpu_torch.ops import smoothers
    k = cells.kernels()["ssor_sweep"]
    assert k.LAUNCHER == "ssor_sweep" == k.launcher(smoothers)

    ns = {}
    exec("def ssor_sweep():\n    ssor_sweep.launches += 1\n", ns)
    old = SimpleNamespace(ssor_sweep=ns["ssor_sweep"],
                          make_ssor=smoothers.make_ssor)
    assert k.launcher(old) == "make_ssor"
    assert k.launcher(SimpleNamespace()) == "make_ssor"
