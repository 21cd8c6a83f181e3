"""The roofline copy's counts on hand-sized inputs."""

import math

import pytest
import torch

from gmg_bench.metrics import _roofline as R
from gmg_bench.trace import LaunchLog


def test_ell_counts_nonzeros_columns_and_vectors():
    cols = torch.zeros(3, 4, dtype=torch.int32)              # K=3, 4 rows
    vals = torch.tensor([[1., 2, 0, 4], [0, 0, 0, 1], [5, 0, 0, 0]])
    x = torch.ones(6)
    nnz = int(torch.count_nonzero(vals))                      # 5
    ops, nbytes = 2 * nnz, nnz * (4 + 4) + (6 + 4) * 4
    assert R.ell_spmv(cols, vals, x, nnz) == pytest.approx(
        max(ops / R.PEAK_FP32, nbytes / R.PEAK_BYTES))


def test_member_counts_against_every_pair():
    g = torch.Generator().manual_seed(3)
    pos = torch.rand(40, 3, generator=g, dtype=torch.float64) * 3
    lower = torch.tensor([[0.0, 0.0, 0.0], [0.25, 0.5, 0.75],
                          [0.25, 0.5, 0.75], [1.0, 1.0, 1.0],
                          [0.1, 0.2, 0.3]], dtype=torch.float64)
    cut2 = 0.8 ** 2
    d = pos[None] - lower[:, None]
    e = d - 0.25
    brute = (torch.minimum(d * d, e * e).sum(-1) < cut2).sum(-1)
    assert torch.equal(R.member_counts(lower, 0.25, pos, cut2), brute)


def test_tile_density_counts_member_terms_not_plan_arrays():
    atoms = torch.full((4, 64), 1.0e6)                        # padded tile
    atoms[:3, :2] = torch.tensor([[0.0, 5.0], [0.0, 5.0], [0.0, 5.0]])
    atoms[3, :2] = 1.0
    anc = torch.tensor([[0.0, 1.0e6], [0.0, 1.0e6], [0.0, 1.0e6]])
    kw = dict(n_q=8, h0=0.25, cut2=1.0, n_out=1)
    plan = (torch.zeros(2, dtype=torch.int32), torch.zeros(1, 10 ** 6),
            None, anc, atoms)
    want = max(12 * 1 * 8 / R.PEAK_FP32,
               (2 * 16 + (8 * 3 + 8) * 4) / R.PEAK_BYTES)
    assert R.tile_density(plan, kw) == pytest.approx(want)


def test_share_weighs_captured_launches_by_replays():
    log = LaunchLog()
    vals = torch.ones(1, 1000)
    cols = torch.zeros(1, 1000, dtype=torch.int32)
    x = torch.ones(1000)
    graph = {"replays": 4}
    log.calls["ell_spmv"] += [((cols, vals, x), {}, None),
                              ((cols, vals, x), {}, graph)]
    one = R.ell_spmv(cols, vals, x, 1000)
    ctx = {"trace": {"kernel_s": {"ell_spmv": 10 * one}, "log": log}}
    assert R.share(ctx, "ell_spmv") == pytest.approx(50.0)
    assert R.share(ctx, "tile_density") is None
    assert R.share({"trace": None}, "ell_spmv") is None
    assert math.isclose(R.bound_s(67e12, 0), 1.0)
