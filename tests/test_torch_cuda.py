"""The hand CUDA kernels of the PyTorch port against their plain PyTorch
versions, on the card.  Every test here needs a CUDA card and skips without
one; the file imports neither jax nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.ops import density as dd, ell, gradient as gr
from coulomb_gmg_tpu_torch.ops import stencil, tile_density as td
from torch_parity import CUT, R_C, adaptive_forest, tile_setup

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_ell_kernel_matches_plain(card, dtype, tol):
    f = adaptive_forest(3)
    ld = f.dofs_of(1).levels[-1]
    t = stencil.level_topology(f, ld, len(f.dofs_of(1).levels) - 1)
    T = torch.from_numpy(stencil.stencil_table(3, element_tables(3, 1, 2)))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    cols, vals, _ = stencil.build_level_ops(
        put(t.coords), put(t.mask8), put(t.elim), put(t.iface),
        put(t.boundary), t.n, T.to(card), dim=3, side=t.side, h=t.h,
        want_iface=False, dtype=dtype)
    x = put(np.random.default_rng(0).standard_normal(t.n)).to(dtype)
    before = ell.ell_mv.launches
    yk = ell.ell_mv(cols, vals, x)
    assert ell.ell_mv.launches == before + 1
    yp = ell.ell_mv_plain(cols, vals, x)
    assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_tile_density_kernel_matches_plain(card, refine_seed):
    f, atoms, tab = tile_setup(2, 2, refine_seed)
    plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                              atoms.charges, CUT, n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, tab.points, plan, R_C, CUT, card)
    before = td.tile_density.launches
    rk = td.tile_density(*args, n_out=f.n_cells + 1, **kw)
    assert td.tile_density.launches == before + 1
    rp = td.tile_density_plain(*args, n_out=f.n_cells + 1, **kw)
    assert torch.equal(rk != 0, rp != 0)
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_tile_density_kernel_takes_only_its_tile(card, refine_seed):
    """The kernel refuses a plan of 512-atom tiles (the TPU's width), whose
    plain version gives the 64-atom kernel's density."""
    f, atoms, tab = tile_setup(2, 2, refine_seed)
    outs = []
    for a_tile in (td.A_TILE, 512):
        plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                                  atoms.charges, CUT, a_tile=a_tile,
                                  n_rows=f.n_cells + 1)
        args, kw = td.plan_operands(f, tab.points, plan, R_C, CUT, card)
        kw["n_out"] = f.n_cells + 1
        if a_tile == td.A_TILE:
            outs.append(td.tile_density(*args, **kw))
        else:
            with pytest.raises(ValueError):
                td.tile_density_cuda(*args, **kw)
            outs.append(td.tile_density_plain(*args, **kw))
    assert torch.equal(outs[0] != 0, outs[1] != 0)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * float(
        outs[1].abs().max())


def test_erf_is_one_past_the_far_threshold_on_card(card):
    """The far path of the gradient kernel assumes the card's erff is
    exactly 1 from FAR on; torch's CUDA erf is that erff."""
    lo, hi = (int(np.float32(v).view(np.int32)) for v in (gr.FAR, 1e4))
    rq = torch.arange(lo, hi + 1, dtype=torch.int32,
                      device=card).view(torch.float32)
    assert bool((torch.special.erf(rq) == 1).all())


def test_expf_is_zero_from_zero_exp_on_card(card):
    """The dense-density kernel skips the terms with r^2 / r_c^2 >=
    ZERO_EXP: its library's expf(-t) is +0 for every float32 t in
    [ZERO_EXP, 1e4], and not for the float32 just below ZERO_EXP."""
    lo, hi = (int(np.float32(v).view(np.int32)) for v in (dd.ZERO_EXP, 1e4))
    t = torch.arange(lo - 1, hi + 1, dtype=torch.int32,
                     device=card).view(torch.float32)
    e = dd.expf_neg_cuda(t)
    assert float(e[0]) > 0
    assert bool((e[1:] == 0).all()) and not bool(torch.signbit(e[1:]).any())


def _dense_skip_on_off(args, kw, card):
    pairs = torch.zeros(1, dtype=torch.int64, device=card)
    on = dd.dense_density_cuda(*args, **kw, pairs=pairs)
    off = dd.dense_density_cuda(*args, **kw, skip_r2=float("inf"))
    return on, off, int(pairs)


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_dense_density_skip_changes_no_bit(card, refine_seed):
    f, atoms, tab = tile_setup(2, 2, refine_seed)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, card)
    kw["n_out"] = f.n_cells + 1
    on, off, pairs = _dense_skip_on_off(args, kw, card)
    assert torch.equal(on, off)
    assert 0 < pairs <= f.n_cells * len(tab.points) * atoms.n


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_density_skip_near_the_zero_distance(card, seed):
    """Atoms within 0.1% of the zero distance sqrt(ZERO_EXP) r_c of cell
    corners and of quadrature points: the skip drops some pairs and changes
    no bit."""
    f, _, tab = tile_setup(2, 2, 2)
    rng = np.random.default_rng(seed)
    lower, h = f.cell_lower(), f.cell_h()
    n = 3000
    c = rng.integers(0, f.n_cells, n)
    q = rng.integers(0, len(tab.points), n)
    at_corner = rng.random(n) < 0.5
    src = lower[c] + np.where(at_corner[:, None], 0.0,
                              h[c, None] * tab.points[q])
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.sqrt(dd.ZERO_EXP) * R_C * (1 + rng.uniform(-1e-3, 1e-3, n))
    pos = src + d * dist[:, None]
    charges = rng.choice([-1.0, 1.0], n) * rng.uniform(0.5, 2.0, n)
    args, kw = dd.density_operands(f, tab.points, pos, charges, R_C, card)
    kw["n_out"] = f.n_cells + 1
    on, off, pairs = _dense_skip_on_off(args, kw, card)
    assert torch.equal(on, off)
    assert 0 < pairs < f.n_cells * len(tab.points) * n
    rp = dd.dense_density_plain(*args, **kw)
    assert float((on - rp).abs().max()) <= 1e-5 * float(rp.abs().max())


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
@pytest.mark.parametrize("K", [27, 8, 5])
@pytest.mark.parametrize("n", [1, 3, 531443])
def test_ell_kernel_matches_plain_at_k_and_n(card, dtype, tol, K, n):
    """Random (K, n) operators with zero padding slots, at the K the kernel
    unrolls (27) and two it loops over in steps of 4 (8, and 5 with a
    tail), at n = 1, 3 and an odd n of the finest 8k level's size."""
    rng = np.random.default_rng(K * 7 + n)
    cols = torch.from_numpy(rng.integers(0, n, (K, n)).astype(
        np.int32)).to(card)
    v = rng.standard_normal((K, n))
    v[rng.random((K, n)) < 0.1] = 0.0
    vals = torch.from_numpy(v).to(card, dtype)
    x = torch.from_numpy(rng.standard_normal(n)).to(card, dtype)
    yk = ell.ell_mv(cols, vals, x)
    yp = ell.ell_mv_plain(cols, vals, x)
    scale = (vals.abs() * x[cols].abs()).sum(0)
    assert bool(((yk - yp).abs() <= tol * scale).all())


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_dense_density_kernel_matches_plain(card, refine_seed):
    f, atoms, tab = tile_setup(2, 2, refine_seed)
    args, kw = dd.density_operands(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, card)
    before = dd.dense_density.launches
    rk = dd.dense_density(*args, n_out=f.n_cells + 1, **kw)
    assert dd.dense_density.launches == before + 1
    rp = dd.dense_density_plain(*args, n_out=f.n_cells + 1, **kw)
    assert not rk[f.n_cells:].any()
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())


def test_exact_gradient_kernel_matches_plain(card):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 4.0, (1000, 3))
    q = rng.choice([-1.0, 1.0], 1000)
    pts = np.vstack([rng.uniform(-1.0, 5.0, (20000, 3)), pos[:3]])
    atoms = dd.pack_atoms(pos, q, card)
    p32 = torch.from_numpy(pts.astype(np.float32)).to(card)
    before = gr.exact_gradient.launches
    gk = gr.exact_gradient(p32, atoms, R_C)
    assert gr.exact_gradient.launches == before + 1
    gp = gr.exact_gradient_plain(p32, atoms, R_C)
    assert torch.isfinite(gk).all()
    assert float((gk - gp).abs().max()) <= 1e-4 * float(gp.abs().max())
    with pytest.raises(TypeError):          # float64: the kernel is f32
        gr.exact_gradient(p32.double(), atoms.double(), R_C)


def test_slice_on_card_8_atoms(card):
    cfg = production_scaling_config(1, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                     pcout=Pcout(enabled=False))
    ell.ell_mv.launches = td.tile_density.launches = 0
    res = sim.run()
    assert [r["n_cells"] for r in res] == [85184, 85744, 87648, 91344,
                                           99464]
    assert all(r["residual"] <= 1.01e-8 * r["l2_rhs"] for r in res)
    assert ell.ell_mv.launches > 0 and td.tile_density.launches == 5


def test_bruteforce_fe_on_card_8_atoms(card):
    cfg = production_scaling_config(1, dtype="float32",
                                    flag_rhs_assembly=False,
                                    flag_postprocess_error=True)
    sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                     pcout=Pcout(enabled=False))
    dd.dense_density.launches = gr.exact_gradient.launches = 0
    res = sim.run()
    assert [r["n_cells"] for r in res] == [85184, 85744, 87648, 91344,
                                           99464]
    fe = [0.301533043384552, 0.2565288841724396, 0.1937119960784912,
          0.1580086201429367, 0.1199013963341713]   # tests/test_torch_driver
    assert all(abs(r["energy_norm_error"] / e - 1) < 1e-4
               for r, e in zip(res, fe))
    assert dd.dense_density.launches == 5
    assert gr.exact_gradient.launches >= 5
