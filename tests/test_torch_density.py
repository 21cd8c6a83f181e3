"""Brute-force density of the PyTorch port (ops/density.py, plain version on
the CPU) against the JAX package: float64 against the brute-force branch of
``compute_density`` (its separable path on the CPU; rel 1e-10), float32
against the Pallas kernel ``density_pallas_cells(..., interpret=True)`` at
the tolerances of tests/test_kernels.py:180 (rtol 5e-4, atol 1e-5); the
padding rows of the RHS-assembly contract exactly zero."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.ops.density import compute_density
from coulomb_gmg_tpu.ops.pallas_density import density_pallas_cells
from coulomb_gmg_tpu_torch.ops import density as dd
from torch_parity import R_C, adaptive_forest, rel_err, t64, tile_setup

torch.set_num_threads(2)


def _atoms(seed=5, A=37):
    """The atoms of tests/test_kernels.py:170."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.2, 1.8, (A, 3)) / 2.0, rng.choice([-1.0, 1.0], A)


@pytest.mark.parametrize("n_q1", [2, 3])
def test_plain_float64_matches_jax_bruteforce(n_q1):
    from coulomb_gmg_tpu.ops.q1 import element_tables
    f = adaptive_forest(3, reps=4, cycles=1)
    tab = element_tables(3, 1, n_q1)
    pos, q = _atoms()
    ref = compute_density(f, tab.points, pos, q, R_C)
    const = 4.0 * np.pi / (R_C ** 3 * np.pi ** 1.5)
    out = dd.dense_density_plain(
        t64(f.cell_lower()), t64(f.cell_h()), t64(tab.points),
        dd.pack_atoms(pos, q, "cpu", torch.float64),
        inv_rc2=1.0 / (R_C * R_C), scale=const, n_out=f.n_cells)
    assert out.dtype == torch.float64
    assert rel_err(out.numpy(), ref) < 1e-10


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_float32_matches_pallas_interpret(refine_seed):
    f, atoms, tab = tile_setup(1, 2, refine_seed)
    ref = np.asarray(density_pallas_cells(
        f.cell_lower(), f.cell_h(), tab.points, atoms.positions,
        atoms.charges, R_C, p_tile=128, a_tile=128, interpret=True))
    out = dd.density_bruteforce(f, tab.points, atoms.positions,
                                atoms.charges, R_C, "cpu",
                                c_pad=f.n_cells + 1)
    assert out.dtype == torch.float32
    assert out.shape == (f.n_cells + 1, len(tab.points))
    np.testing.assert_allclose(out[: f.n_cells].numpy(), ref, rtol=5e-4,
                               atol=1e-5)


def test_padding_rows_exactly_zero():
    f, atoms, tab = tile_setup(1, 2)
    out = dd.density_bruteforce(f, tab.points, atoms.positions,
                                atoms.charges, R_C, "cpu",
                                c_pad=f.n_cells + 3)
    assert out.shape[0] == f.n_cells + 3
    assert not out[f.n_cells:].any()
    assert out[: f.n_cells].abs().max() > 0


def test_cpu_dispatch_is_plain_and_cuda_path_never_falls_back():
    f, atoms, tab = tile_setup(1, 2)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, "cpu")
    before = dd.dense_density.launches
    out = dd.dense_density(*args, n_out=f.n_cells, **kw)
    assert torch.equal(out, dd.dense_density_plain(*args, n_out=f.n_cells,
                                                   **kw))
    assert dd.dense_density.launches == before
    with pytest.raises(ValueError):
        dd.dense_density_cuda(*args, n_out=f.n_cells, **kw)


@pytest.mark.parametrize("r_c", [0.1, 0.5, 1.0, 2.5, 3.7])
def test_zero_r2_in_float32(r_c):
    """The skip distance^2, rounded to float32 as the kernel takes it, times
    the float32 1/r_c^2 is ZERO_EXP raised by about the 1e-4 margin, both
    from r_c and from the r_c the wrapper recovers from inv_rc2."""
    inv = np.float32(1.0 / (r_c * r_c))
    for rc in (r_c, float(inv) ** -0.5):
        z = np.float32(dd.zero_r2(rc))
        assert z > np.float32(dd.ZERO_EXP * r_c * r_c)
        t = np.float32(z * inv)
        assert dd.ZERO_EXP * (1 + 0.9e-4) <= t <= dd.ZERO_EXP * (1 + 1.1e-4)


def _f32_fma(a, b, c):
    """fma in float32, through float64 (the product of two float32 values
    is exact there)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _sq3(dx, dy, dz, fused):
    """dx^2 + dy^2 + dz^2 in float32, plainly rounded or as the compiler
    contracts it, fma(dz, dz, fma(dy, dy, dx * dx))."""
    if fused:
        return _f32_fma(dz, dz, _f32_fma(dy, dy, dx * dx))
    return dx * dx + dy * dy + dz * dz


def _box_d2(lo, hi, X, fused):
    """Squared distance from points X (..., 3) to the box [lo, hi], as the
    kernel's box tests compute it in float32."""
    d = np.maximum(np.maximum(lo - X, X - hi), np.float32(0))
    return _sq3(d[..., 0], d[..., 1], d[..., 2], fused)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_box_test_model_never_drops_a_live_pair(seed, fused):
    """A numpy float32 model of the kernel's two box tests (a warp's 64
    points, 8 cells in a row along z, against atoms and against groups of
    32 atoms) on atoms within 0.03% of the zero distance: no atom or group
    that the tests skip has a pair whose float32 r^2 * inv_rc2 is below
    ZERO_EXP, and the tests do skip some."""
    rng = np.random.default_rng(seed)
    r_c = float(rng.choice([0.5, 0.37, 1.3]))
    f32 = np.float32
    inv = f32(1.0 / (r_c * r_c))
    z2 = f32(dd.zero_r2(r_c))
    h = f32(0.25 * rng.choice([1.0, 0.5]))
    g = 0.5 - 0.5 / np.sqrt(3.0)
    pref = np.array([[a, b, c] for a in (g, 1 - g) for b in (g, 1 - g)
                     for c in (g, 1 - g)], np.float32)
    lower = (f32(-3.0) + h * np.stack(
        [np.full(8, 5), np.full(8, 7), np.arange(8)], 1)).astype(np.float32)
    pts = (lower[:, None, :] + h * pref[None]).reshape(-1, 3)  # float32 ops
    lo, hi = pts.min(0), pts.max(0)
    # atoms in groups of 32, each group outward from one corner of the box
    # (every corner is one of the points), at 1 +- 3e-4 times the zero
    # distance from it
    n_g, n = 64, 64 * 32
    corner = np.where(rng.random((n_g, 3)) < 0.5, lo, hi).repeat(32, 0)
    d = np.abs(rng.standard_normal((n_g, 3))).repeat(32, 0) \
        + 0.2 * np.abs(rng.standard_normal((n, 3)))
    d *= np.where(corner == lo, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.sqrt(dd.ZERO_EXP) * r_c * (1 + rng.uniform(-3e-4, 3e-4, n))
    X = (corner + d * dist[:, None]).astype(np.float32)
    dp = pts[:, None, :] - X[None]                        # (64, n, 3)
    t = _sq3(dp[..., 0], dp[..., 1], dp[..., 2], fused) * inv
    live = (t < dd.ZERO_EXP).any(0)                       # per atom
    skip = _box_d2(lo, hi, X, fused) >= z2
    assert skip.any() and (~skip).any() and live.any()
    assert not (skip & live).any()
    glo = X.reshape(-1, 32, 3).min(1)
    ghi = X.reshape(-1, 32, 3).max(1)
    gd = np.maximum(np.maximum(glo - hi, lo - ghi), f32(0))
    gskip = _sq3(gd[:, 0], gd[:, 1], gd[:, 2], fused) >= z2
    assert not (gskip & live.reshape(-1, 32).any(1)).any()
    assert (gskip == skip.reshape(-1, 32).all(1))[gskip].all()


def _cpu_operands():
    f, atoms, tab = tile_setup(1, 2)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, "cpu")
    return list(args), dict(kw, n_out=f.n_cells + 1)


@pytest.mark.parametrize("fault, error, match", [
    ("float64", TypeError, "float32"),
    ("short h", ValueError, "shapes"),
    ("n_out", ValueError, "shapes"),
    ("unaligned atoms", ValueError, "aligned"),
    ("strided pref", ValueError, "contiguous"),
    ("pairs dtype", ValueError, "pairs"),
    ("skip_r2 nan", ValueError, "skip_r2"),
    ("none", ValueError, "on the card"),
])
def test_cuda_wrapper_checks_raise_on_cpu_tensors(fault, error, match):
    args, kw = _cpu_operands()
    if fault == "float64":
        args = [a.double() for a in args]
    elif fault == "short h":
        args[1] = args[1][:-1]
    elif fault == "n_out":
        kw["n_out"] = args[0].shape[0] - 1
    elif fault == "unaligned atoms":
        A = args[3]
        buf = torch.zeros(A.numel() + 1, dtype=torch.float32)
        args[3] = buf[1:].view(A.shape)
        assert args[3].is_contiguous() and args[3].data_ptr() % 16
    elif fault == "strided pref":
        args[2] = torch.cat([args[2], args[2]], 1)[:, ::2]
    elif fault == "pairs dtype":
        kw["pairs"] = torch.zeros(1, dtype=torch.int32)
    elif fault == "skip_r2 nan":
        kw["skip_r2"] = float("nan")
    with pytest.raises(error, match=match):
        dd.dense_density_cuda(*args, **kw)
