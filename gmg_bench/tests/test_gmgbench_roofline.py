"""The roofline copy's counts on hand-sized inputs: each kernel's file of
gmg_bench/kernels/ against a count of every pair, and the files of the
kernels that cells read against the functions they replaced."""

import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from gmg_bench import cells
from gmg_bench.metrics import _roofline as R
from gmg_bench.trace import LaunchLog

K = cells.kernels()


def test_ell_counts_nonzeros_columns_and_vectors():
    cols = torch.zeros(3, 4, dtype=torch.int32)              # K=3, 4 rows
    vals = torch.tensor([[1., 2, 0, 4], [0, 0, 0, 1], [5, 0, 0, 0]])
    x = torch.ones(6)
    nnz = int(torch.count_nonzero(vals))                      # 5
    ops, nbytes = 2 * nnz, nnz * (4 + 4) + (6 + 4) * 4
    assert K["ell_spmv"].bound_s((cols, vals, x), {}) == pytest.approx(
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
    assert K["tile_density"].bound_s(plan, kw) == pytest.approx(want)


def test_share_weighs_captured_launches_by_replays():
    log = LaunchLog()
    vals = torch.ones(1, 1000)
    cols = torch.zeros(1, 1000, dtype=torch.int32)
    x = torch.ones(1000)
    graph = {"replays": 4}
    log.calls["ell_spmv"] += [((cols, vals, x), {}, None),
                              ((cols, vals, x), {}, graph)]
    one = K["ell_spmv"].bound_s((cols, vals, x), {})
    ctx = {"trace": {"kernel_s": {"ell_spmv": 10 * one}, "log": log}}
    assert R.share(ctx, "ell_spmv") == pytest.approx(50.0)
    assert R.share(ctx, "tile_density") is None
    assert R.share({"trace": None}, "ell_spmv") is None
    assert math.isclose(R.bound_s(67e12, 0), 1.0)


# the parent's functions that the files of ell_spmv and tile_density
# replaced, as they stood
def _old_ell_spmv(cols, vals, x, nnz):
    rows = cols.n_rows if hasattr(cols, "n_rows") else cols.shape[-1]
    return R.bound_s(2 * nnz, nnz * (4 + vals.element_size())
                     + (x.numel() + rows) * x.element_size())


def _old_tile_density(args, kw):
    _, _, _, anc, atoms = args
    n_q = kw["n_q"]
    lower = anc.T
    real = lower.abs().amax(-1) < R.FAR_AWAY
    X = atoms[:3].T
    live = X.abs().amax(-1) < R.FAR_AWAY
    members = int(R.member_counts(lower[real], kw["h0"], X[live],
                                  kw["cut2"]).sum())
    n_out = kw["n_out"]
    n_bytes = int(live.sum()) * 16 + (n_out * n_q * 3 + n_out * n_q) * 4
    return R.bound_s(R.OPS_DENSITY * members * n_q, n_bytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_bound_is_the_old_functions_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(11)
    vals = torch.rand(27, 500, generator=g, dtype=dtype)
    vals[vals < 0.3] = 0
    cols = torch.randint(0, 500, (27, 500), generator=g, dtype=torch.int32)
    x = torch.rand(500, generator=g, dtype=dtype)
    sliced = SimpleNamespace(n_rows=480, cols=cols)
    for c in (cols, sliced):
        nnz = int(torch.count_nonzero(vals))
        assert K["ell_spmv"].bound_s((c, vals, x), {}) == \
            _old_ell_spmv(c, vals, x, nnz)


def test_tile_bound_is_the_old_functions_bit_for_bit():
    g = torch.Generator().manual_seed(5)
    atoms = torch.full((4, 128), 1.0e6)
    atoms[:3, :100] = torch.rand(3, 100, generator=g) * 4
    atoms[3, :100] = 1.0
    anc = torch.full((3, 40), 1.0e6)
    anc[:, :33] = torch.randint(0, 16, (3, 33), generator=g) * 0.25
    for kw in (dict(n_q=8, h0=0.25, cut2=1.75 ** 2, n_out=33),
               dict(n_q=27, h0=0.25, cut2=0.5, n_out=64)):
        args = (None, None, None, anc, atoms)
        assert K["tile_density"].bound_s(args, kw) == \
            _old_tile_density(args, kw)


def _every_pair(points, atoms, r2):
    return sum(int(((points[i] - atoms[j]) ** 2).sum() < r2)
               for i in range(points.shape[0]) for j in range(atoms.shape[0]))


def test_pairs_within_against_every_pair():
    g = torch.Generator().manual_seed(9)
    pts = torch.rand(5000, 3, generator=g, dtype=torch.float64) * 6 - 1
    X = torch.rand(70, 3, generator=g, dtype=torch.float64) * 4
    X[:8] = pts[:8] + torch.tensor([0.5, 0.0, 0.0], dtype=torch.float64)
    for r2 in (0.25, 1.0, 4.0, 100.0):
        d = pts[:, None, :] - X[None]
        assert R.pairs_within(pts, X, r2) == int(((d * d).sum(-1)
                                                   < r2).sum())
    assert R.pairs_within(pts[:40], X, 1.0) == _every_pair(pts[:40], X, 1.0)


def test_exact_gradient_counts_every_pair():
    g = torch.Generator().manual_seed(2)
    pts = (torch.rand(60, 3, generator=g) * 6).float()
    atoms = torch.zeros(9, 4)
    atoms[:, :3] = torch.rand(9, 3, generator=g) * 4
    atoms[:, 3] = 1.0
    r_c = 0.5
    near = _every_pair(pts.double(), atoms[:, :3].double(),
                       (K["exact_gradient"].NEAR * r_c) ** 2)
    assert 0 < near < 60 * 9
    ops = 18 * (60 * 9 - near) + 27 * near
    assert K["exact_gradient"].bound_s((pts, atoms, r_c), {}) == \
        R.bound_s(ops, 60 * 24 + 9 * 16)


def test_dense_density_counts_the_terms_that_are_not_zero():
    g = torch.Generator().manual_seed(4)
    lower = (torch.randint(0, 40, (12, 3), generator=g) * 0.25).float()
    h = torch.full((12,), 0.25)
    pref = torch.rand(8, 3, generator=g).float()
    atoms = torch.zeros(7, 4)
    atoms[:, :3] = torch.rand(7, 3, generator=g) * 10
    atoms[:, 3] = 1.0
    kw = dict(inv_rc2=4.0, scale=1.0, n_out=13)
    pts = (lower.double()[:, None] + h.double()[:, None, None]
           * pref.double()).reshape(-1, 3)
    terms = sum(int(math.exp(-float(((pts[i] - atoms[j, :3].double()) ** 2)
                                    .sum()) * 4.0) > 2.0 ** -150)
                for i in range(pts.shape[0]) for j in range(7))
    assert 0 < terms < 96 * 7
    want = R.bound_s(12 * terms, 4 * (4 * 12 + 3 * 8 + 4 * 7 + 13 * 8))
    assert K["dense_density"].bound_s((lower, h, pref, atoms), kw) == \
        want


def test_a_new_kernel_is_found_by_name(tiny_root, tmp_path, monkeypatch):
    lib = tmp_path / "toylib"
    lib.mkdir()
    (lib / "toy_ops.py").write_text(
        "def launch(x):\n    return x + 1\n")
    monkeypatch.syspath_prepend(str(lib))
    with open(os.path.join(tiny_root, "gmg_bench", "kernels", "toy.py"),
              "w") as fh:
        fh.write("MODULE = 'toy_ops'\nLAUNCHER = 'launch'\n"
                 "DEVICE = ('toy_kernel',)\n\n"
                 "def bound_s(args, kw):\n"
                 "    return float(args[0].numel())\n")
    import toy_ops
    log = LaunchLog(tiny_root)
    assert set(log.kernels) == set(K) | {"toy"}
    with log:
        toy_ops.launch(torch.ones(3))
        toy_ops.launch(torch.ones(5))
    assert toy_ops.launch(torch.ones(2)).sum() == 4   # unwrapped again
    assert len(log.calls["toy"]) == 2
    ctx = {"trace": {"kernel_s": {"toy": 16.0}, "log": log}}
    assert R.share(ctx, "toy") == pytest.approx(50.0)
    sys.modules.pop("toy_ops", None)
