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
from coulomb_gmg_tpu_torch.ops.ell import ELL, SlicedELL
from torch_parity import CUT, R_C, adaptive_forest, random_csr, tile_setup

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


def system_like_8k(seed: int = 0):
    """A random CSR with the row lengths of the 8,000-atom float64 system
    (614,973 rows: most of 27 entries, some of 1 and 18, ~1.2% of 28 to
    51)."""
    n = 614973
    rng = np.random.default_rng(seed)
    counts = rng.choice([27, 1, 18], n, p=[0.855, 0.07, 0.075])
    long = rng.random(n) < 0.012
    counts[long] = rng.integers(28, 52, int(long.sum()))
    counts[n // 2] = 51
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, n, indptr[-1])
    return indptr, indices, rng.standard_normal(indptr[-1])


SLICED_CASES = [(1, 0), (7, 0), (8, 0), (9, 13), (31, 0), (32, 0), (33, 13),
                (3000, 13), ("8k", 0)]


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
@pytest.mark.parametrize("n, pad", SLICED_CASES)
def test_sliced_ell_kernel_is_the_padded_kernel(card, dtype, tol, n, pad):
    """The sliced kernel (in blocks of 64 threads on the small cases, of
    256 on the 8k-sized one) gives the padded kernel's values on the padded
    form of the same operator, and the plain version's to tol times the
    row's absolute sum."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    indptr, indices, data = (system_like_8k() if n == "8k"
                             else random_csr(n, np_dt, seed=n))
    n = len(indptr) - 1
    sl, vals = SlicedELL.from_csr(indptr, indices, data,
                                  pad_rows_to=n + pad).device(card, dtype)
    padded = ELL.from_csr(indptr, indices, data,
                          pad_rows_to=n + pad).device(card, dtype)
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)).to(
        card, dtype)
    before = ell.ell_mv.launches
    y = ell.ell_mv(sl, vals, x)
    assert ell.ell_mv.launches == before + 1
    assert torch.equal(y, ell.ell_mv(*padded, x))
    yp = ell.ell_mv_plain(sl, vals, x)
    scale = ell.ell_mv_plain(sl, vals.abs(), x.abs())
    assert bool(((y - yp).abs() <= tol * scale).all())


def test_sliced_ell_product_in_a_cuda_graph(card):
    """A CUDA graph that captured one sliced product replays it to the
    eager product's bits, on the inputs it finds at replay."""
    indptr, indices, data = random_csr(3000, np.float64, seed=7)
    sl, vals = SlicedELL.from_csr(indptr, indices, data).device(card)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(3000)).to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ell.ell_mv(sl, vals, x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = ell.ell_mv(sl, vals, x)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, ell.ell_mv(sl, vals, x))
        x.copy_(torch.from_numpy(rng.standard_normal(3000)))


@pytest.mark.parametrize("fault, error, match", [
    ("x dtype", TypeError, "dtypes"),
    ("vals float16", TypeError, "dtypes"),
    ("vals on the host", ValueError, "on the card"),
    ("x on the host", ValueError, "on the card"),
    ("shape", ValueError, "shapes"),
    ("strided vals", ValueError, "contiguous"),
])
def test_sliced_ell_kernel_raises(card, fault, error, match):
    indptr, indices, data = random_csr(33, np.float64, seed=5)
    sl, vals = SlicedELL.from_csr(indptr, indices, data).device(card)
    x = torch.ones(33, dtype=torch.float64, device=card)
    if fault == "x dtype":
        x = x.float()
    elif fault == "vals float16":
        vals, x = vals.half(), x.half()
    elif fault == "vals on the host":
        vals = vals.cpu()
    elif fault == "x on the host":
        x = x.cpu()
    elif fault == "shape":
        vals = vals[:-1]
    elif fault == "strided vals":
        vals = torch.stack([vals, vals], 1)[:, 0]
    before = ell.ell_mv.launches
    with pytest.raises(error, match=match):
        ell.ell_mv_cuda(sl, vals, x)
    assert ell.ell_mv.launches == before


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


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("dim, reps, seed", [(2, 12, 0), (3, 6, 1)])
def test_topology_on_card_is_the_cpu_topology(card, dim, reps, seed, degree):
    """Every topology function of the cycle (topology.topology_outputs:
    DoF numbering, hanging pairs, level DoFs and cells, level topology,
    copy maps, covering map, transfer, face plans, Kelly estimate with its
    volume term, marking) returns tensors on the card equal to the CPU's:
    integers and flags exactly, float64 arrays within rel 1e-14, on the
    seeded forests of tests/test_torch_host.py."""
    from coulomb_gmg_tpu_torch.mesh.forest import Forest
    from coulomb_gmg_tpu_torch.topology import topology_outputs
    f = Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
    rng = np.random.default_rng(seed)
    forests = [f]
    for _ in range(2):
        f = f.refine(rng.random(f.n_cells) < 0.2)
        forests.append(f)
    old, new = forests[-2], forests[-1]
    u_old = rng.standard_normal(old.dofs_of(degree).n_dofs)
    u_new = rng.standard_normal(new.dofs_of(degree).n_dofs)
    rho = rng.standard_normal((new.n_cells, (degree + 1) ** dim))
    cpu = topology_outputs(old.on("cpu"), new.on("cpu"), u_old, u_new,
                           degree, rho)
    got = topology_outputs(old.on(card), new.on(card), u_old, u_new, degree,
                           rho)
    assert list(got) == list(cpu)
    for name, t in got.items():
        ref = cpu[name]
        assert t.device.type == "cuda", name
        assert t.dtype == ref.dtype and t.shape == ref.shape, name
        if t.is_floating_point() and ref.numel():
            rel = (t.cpu() - ref).abs().max() / ref.abs().max()
            assert rel <= 1e-14, (name, float(rel))
        else:
            assert torch.equal(t.cpu(), ref), name


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


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_csr_products_and_mc_ssor_on_card(card, dtype, tol):
    """The host-assembled CSR's products and the multicolour SSOR through
    the ELL kernel against the same operators on the CPU."""
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    from coulomb_gmg_tpu_torch.ops.smoothers import lattice_color, \
        make_mc_ssor
    from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
    f = adaptive_forest(3)
    dofs = f.dofs_of(1)
    g = build_gmg(f, dofs, element_tables(3, 1, 2), smoother="none",
                  dtype=dtype, device="cpu")
    A, P = g.matrices[-1], g.prolongations[-1]
    rng = np.random.default_rng(3)
    for M in (A, P):
        Mc = CSR.from_pattern(M.indptr, M.indices, M.data.to(card),
                              n_cols=M.n_cols)
        for name, n in (("matvec", M.n_cols), ("matvec_T", M.n_rows)):
            x = torch.from_numpy(rng.standard_normal(n)).to(dtype)
            before = ell.ell_mv.launches
            yk = getattr(Mc, name)(x.to(card)).cpu()
            assert ell.ell_mv.launches == before + 1
            yp = getattr(M, name)(x)
            assert float((yk - yp).abs().max()) <= tol * float(
                yp.abs().max())
    color = lattice_color(f, dofs.levels[-1])
    Ac = CSR.from_pattern(A.indptr, A.indices, A.data.to(card))
    r = torch.from_numpy(rng.standard_normal(A.n_rows)).to(dtype)
    zk = make_mc_ssor(Ac, color, 0.5)(r.to(card)).cpu()
    zp = make_mc_ssor(A, color, 0.5)(r)
    assert float((zk - zp).abs().max()) <= tol * float(zp.abs().max())


def test_float64_density_on_card_matches_cpu(card):
    from coulomb_gmg_tpu_torch.ops.neighbors import atom_lists
    f, atoms, tab = tile_setup(1, 2, 2)
    lists, _ = atom_lists(f, atoms.positions, CUT)
    outs = [dd.compute_density(f, tab.points, atoms.positions, atoms.charges,
                               R_C, dev, lists=lists).cpu()
            for dev in (card, "cpu")]
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-13 * float(
        outs[1].abs().max())


def _list_density_case(mesh):
    """The cycle-0 mesh's compact lists, on that mesh or carried over two
    random refinements (each child reading its cycle-0 ancestor's row)."""
    from coulomb_gmg_tpu_torch.adapt.transfer import old_cell_of_new
    from coulomb_gmg_tpu_torch.mesh.forest import to_host
    from coulomb_gmg_tpu_torch.ops.neighbors import locality_lists
    f, atoms, _ = tile_setup(2, 2)
    lists = locality_lists(f, atoms.positions, CUT)
    if mesh == "refined":
        rng = np.random.default_rng(7)
        for _ in range(2):
            new = f.refine(rng.random(f.n_cells) < 0.1)
            lists = lists.carried(to_host(old_cell_of_new(f, new)))
            f = new
    return f, atoms, lists


@pytest.mark.parametrize("mesh", ["uniform", "refined"])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-14),
                                        (torch.float32, 1e-6)])
def test_list_density_kernel_matches_plain(card, dtype, tol, mesh):
    """csrc/list_density.cu against the plain list branch on the CPU, on
    the 2- and 5-point rules (n1 a template argument) and the 6-point rule
    (n1 at run time); empty rows and the padding row exactly zero;
    the same bits on repeat; the counter equals the host count."""
    from coulomb_gmg_tpu_torch.utils.timer import TimerOutput, span
    f, atoms, lists = _list_density_case(mesh)
    counts = lists.counts
    assert 0 < (counts == 0).sum() < f.n_cells
    for n1 in (2, 5, 6):
        pts = element_tables(3, 1, n1).points
        args = (f, pts, atoms.positions, atoms.charges, R_C)
        before = dd.list_density.launches
        tr = TimerOutput()
        with tr.run(), span("density.kernel"):
            rk = dd.compute_density(*args, card, lists=lists, dtype=dtype,
                                    n_out=f.n_cells + 1)
        assert dd.list_density.launches == before + 1
        assert tr.summarize()["counters_by_span"]["density.kernel"][
            "density_list_entries"] == int(counts.sum())
        again = dd.compute_density(*args, card, lists=lists, dtype=dtype,
                                   n_out=f.n_cells + 1)
        assert rk.dtype == dtype and torch.equal(rk, again)
        rk = rk.cpu()
        rp = dd.compute_density(*args, "cpu", lists=lists, dtype=dtype)
        assert float((rk[:-1] - rp).abs().max()) <= tol * float(
            rp.abs().max())
        empty = torch.from_numpy(np.append(counts == 0, True))
        assert (rk[empty] == 0).all() and (rk[~empty] != 0).any()


def test_list_density_takes_masks_and_shards(card):
    """A mask and padded lists go through the same kernel; a shard's block
    of cells (parallel/spmd.py) reads its rows of home."""
    f, atoms, lists = _list_density_case("refined")
    args = (f, element_tables(3, 1, 2).points, atoms.positions,
            atoms.charges, R_C, card)
    whole = dd.compute_density(*args, lists=lists)
    mask = np.zeros((f.n_cells, len(atoms.charges)), bool)
    pad = lists.padded()
    rows = np.nonzero(pad >= 0)[0]
    mask[rows, pad[pad >= 0]] = True
    before = dd.list_density.launches
    by_mask = dd.compute_density(*args, mask=mask)
    by_padded = dd.compute_density(*args, lists=pad)
    assert dd.list_density.launches == before + 2
    assert torch.equal(by_padded, whole)
    assert float((by_mask - whole).abs().max()) <= 1e-14 * float(
        whole.abs().max())
    cells = range(f.n_cells // 3, 2 * f.n_cells // 3)
    part = dd.compute_density(*args, lists=lists, cells=cells)
    assert torch.equal(part, whole[cells.start:cells.stop])


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_host_assembled_step16_on_card(card, precision):
    """examples/step-16.prm, 3 cycles, on the card and on the CPU: the same
    cells and CG counts; the ELL kernel runs in the working precision and
    in float64 (the true residual, the refinement defect)."""
    import os
    from coulomb_gmg_tpu_torch.config import load_prm
    from coulomb_gmg_tpu_torch.io.lammps import read_lammps_file
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for dev in (card, "cpu"):
        cfg = load_prm(os.path.join(root, "examples", "step-16.prm"),
                       dtype=precision, n_adaptive_cycles=3,
                       flag_rhs_assembly=precision == "float32")
        atoms = read_lammps_file(os.path.join(root, cfg.lammps_file))
        sim = Simulation(cfg, atoms=atoms, device=dev,
                         pcout=Pcout(enabled=False))
        ell.ell_mv.launches = ell.ell_mv.launches_f64 = 0
        res = sim.run()
        out.append(([r["n_cells"] for r in res],
                    [r["cg_iterations"] for r in res]))
        assert all(r["residual"] <= 1.01e-8 * r["l2_rhs"] for r in res)
        if dev == card:
            assert ell.ell_mv.launches_f64 > 0
            assert ell.ell_mv.launches > ell.ell_mv.launches_f64 or \
                precision == "float64"
    assert out[0][0] == out[1][0]
    assert all(abs(a - b) <= 1 for a, b in zip(out[0][1], out[1][1]))


@pytest.fixture(scope="module", params=[2, 5], ids=["64", "1000"])
def card_ssors(request):
    """The SSOR smoothers of the float64 host-assembled run of 8 n^3 atoms
    on the card (5 cycles), one per smoothed level of every hierarchy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = production_scaling_config(request.param, dtype="float64",
                                    device_operators="off")
    sim = Simulation(cfg, atoms=nacl_lattice(request.param), device="cuda",
                     pcout=Pcout(enabled=False))
    sim.run()
    return [e[3].precond for e in sim._gmg_cache.values()
            if e[3] is not None]


def test_card_ssor_is_the_host_ssor(card_ssors):
    """Each level's card sweep against the scipy sweep on the same matrix
    and defect: max |d| <= 1e-13 max |y|, the same bits on every repeat,
    one ``ssor_card_calls``, one span and one launch an application."""
    from coulomb_gmg_tpu_torch import kernels
    from coulomb_gmg_tpu_torch.ops.smoothers import CardSSOR, HostSSOR, \
        ssor_sweep
    from coulomb_gmg_tpu_torch.utils.timer import TimerOutput
    assert card_ssors and all(isinstance(s, CardSSOR) for s in card_ssors)
    rng = np.random.default_rng(11)
    for s in card_ssors:
        dev = s.A.data.device
        r = torch.from_numpy(rng.standard_normal(s.A.n_rows)).to(dev)
        key = ("ssor_sweep", dev.index)
        before = (kernels.LAUNCHES.get(key, 0), ssor_sweep.launches)
        with TimerOutput().run() as tr:
            y = s(r)
        run = tr.summarize()
        assert run["counters"]["run"]["ssor_card_calls"] == 1
        assert run["spans"]["smoother.ssor"]["calls"] == 1
        assert (kernels.LAUNCHES[key], ssor_sweep.launches) == (
            before[0] + 1, before[1] + 1)
        yh = HostSSOR(s.A, 0.5)(r.cpu())
        assert y.dtype == torch.float64
        assert float((y.cpu() - yh).abs().max()) <= 1e-13 * float(
            yh.abs().max())
        assert all(torch.equal(s(r), y) for _ in range(8))


def test_card_ssor_in_float32(card_ssors):
    """A float32 level matrix and defect: read as float32, summed in
    float64, rounded once to float32, so within 1 ulp of the scipy sweep's
    float32 result (plus 1e-13 max |y| where cancellation leaves an
    element far below the largest)."""
    from coulomb_gmg_tpu_torch.ops.smoothers import CardSSOR, HostSSOR
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    rng = np.random.default_rng(12)
    for s in card_ssors:
        A = s.A
        A32 = CSR.from_pattern(A.indptr, A.indices, A.data.float())
        r = torch.from_numpy(rng.standard_normal(A.n_rows)).float().to(
            A.data.device)
        y = CardSSOR(A32, 0.5)(r).cpu()
        yh = HostSSOR(A32, 0.5)(r.cpu())
        assert y.dtype == yh.dtype == torch.float32
        ulp = torch.nextafter(yh.abs(), torch.tensor(np.inf)) - yh.abs()
        assert bool(((y - yh).abs() <= ulp + 1e-13 * float(
            yh.abs().max())).all())


def test_card_ssor_refuses_what_it_does_not_take(card_ssors):
    s = card_ssors[-1]
    n, dev = s.A.n_rows, s.A.data.device
    r = torch.ones(2 * n, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        s(r[::2])
    with pytest.raises(ValueError, match="shapes"):
        s(r[:n + 1])
    with pytest.raises(TypeError, match="float32/float64"):
        s(r[:n].float())


@pytest.fixture(scope="module", params=[2, 5], ids=["64", "1000"])
def card_checks(request):
    """The inputs of every Solve check of the float64 host-assembled run of
    8 n^3 atoms on the card (5 cycles): (b, x, constraints, system)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from coulomb_gmg_tpu_torch import driver
    got, real = [], driver.card_check

    def record(b, x, con, system=None, defect=None):
        got.append((b.clone(), x.clone(), con, system))
        return real(b, x, con, system=system, defect=defect)
    cfg = production_scaling_config(request.param, dtype="float64",
                                    device_operators="off")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "card_check", record)
        Simulation(cfg, atoms=nacl_lattice(request.param), device="cuda",
                   pcout=Pcout(enabled=False)).run()
    return got


def test_solve_check_kernels_are_their_plain_versions(card_checks):
    """Each cycle's check on the card against the plain versions on the
    CPU: the column and row sums of |a| and the distributed solution to
    the bit, the Frobenius and vector norms within 1e-13 relative (the
    card and the CPU sum in different orders), the residual within 1e-13
    ||b||
    (the ELL kernel's FMA chains against the plain product); the same
    bits on repeat; two launches of each kernel a check."""
    from coulomb_gmg_tpu_torch.ops.ell import Slices
    from coulomb_gmg_tpu_torch.solver import check
    assert len(card_checks) == 5
    for b, x, con, (sl, vals) in card_checks:
        assert x.is_cuda and vals.dtype == torch.float64
        before = (check.matrix_norms.launches, check.distribute_rows.launches)
        got = check.card_check(b, x, con, (sl, vals))
        assert (check.matrix_norms.launches,
                check.distribute_rows.launches) == (before[0] + 1,
                                                    before[1] + 1)
        for _ in range(3):
            again = check.card_check(b, x, con, (sl, vals))
            assert again.residual == got.residual
            assert again.norms == got.norms
            assert np.array_equal(again.solution, got.solution)
        cpu = (Slices(sl.off.cpu(), sl.cols.cpu(), sl.n_rows, sl.width),
               vals.cpu())
        plain = check.card_check(b.cpu(), x.cpu(), con, cpu)
        for k in ("l1_mat", "linf_mat"):
            assert got.norms[k] == plain.norms[k], k
        for k in ("fro_mat", "l1_rhs", "l2_rhs", "linf_rhs", "l1_sol",
                  "l2_sol", "linf_sol"):
            assert abs(got.norms[k] - plain.norms[k]) <= 1e-13 * abs(
                plain.norms[k]), k
        assert np.array_equal(got.solution, plain.solution)
        assert abs(got.residual - plain.residual) <= 1e-13 * \
            got.norms["l2_rhs"]
        assert got.residual <= 1.01e-8 * got.norms["l2_rhs"]


def test_solve_check_refuses_what_it_does_not_take(card_checks):
    from coulomb_gmg_tpu_torch.solver import check
    b, x, con, (sl, vals) = card_checks[-1]
    out = torch.zeros(8, dtype=torch.float64, device=x.device)
    with pytest.raises(TypeError, match="float64"):
        check.matrix_norms(sl, vals.float(), out)
    with pytest.raises(ValueError, match="contiguous"):
        check.matrix_norms(sl, vals, out[::2])
    with pytest.raises(ValueError, match="one card"):
        check.matrix_norms(sl, vals, out.cpu())
    with pytest.raises(ValueError, match="card_check"):
        check.card_check(b.cpu(), x, con, (sl, vals))


def test_sharded_tile_density_on_card(card):
    """Three shards of the tile kernel on one card: the same bits as one
    launch over the whole plan, one launch per shard."""
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    f, atoms, tab = tile_setup(2, 2, 2)
    args = (f, tab.points, atoms.positions, atoms.charges, R_C)
    one = td.density_locality_tiles(*args, CUT, card, c_pad=f.n_cells)
    before = td.tile_density.launches
    got = SpmdContext(3, ["cuda:0"] * 3).density_tiles(*args, CUT)
    assert td.tile_density.launches == before + 3
    assert got.is_cuda and torch.equal(got, one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_ell_apply_on_card(card, dtype):
    """A CSR operator row-partitioned over three shards of one card, ghosts
    imported: the ELL kernel per shard gives the single-device kernel's
    bits."""
    from coulomb_gmg_tpu_torch.fem import card_assembly as CA
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        HaloPlan, ShardedCSR, apply_ells, halo_import, put_blocks,
        shard_ells, shard_vector)
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    from torch_parity import refined_problem
    f, dofs, con, _, _ = refined_problem(2)
    plan = CA.plan(dofs.cell2dof.to(card), CA.card_constraints(con, card))
    K = CA.cell_matrices(element_tables(3, 1, 2),
                         torch.from_numpy(f.cell_h()).to(card))
    data = CA.assemble(plan, K)[0].cpu().numpy()
    A = CSR.from_pattern(plan.pattern.indptr, plan.pattern.indices, data,
                         device=card)
    x = np.random.default_rng(3).standard_normal(A.n_rows)
    y1 = ell.ell_mv(*A.ell(dtype=dtype), torch.from_numpy(x).to(card, dtype))
    ctx = SpmdContext(3, ["cuda:0"] * 3)
    S = ShardedCSR.from_coo(A.rowids, A.indices, data, A.n_rows, 3)
    hp = HaloPlan.build(S.cols, S.block, 3)
    ells = shard_ells(S.rows_local, hp.cols_local, S.data, S.block, ctx,
                      dtype)
    before = ell.ell_mv.launches
    ys = apply_ells(ells, halo_import(put_blocks(shard_vector(x, 3), ctx,
                                                 dtype), hp, ctx))
    assert ell.ell_mv.launches == before + 3
    assert torch.equal(torch.cat(ys)[: A.n_rows], y1)


FUSED_ROUTES = {"device_ops": dict(device_operators="on"),
                "tpu_gmg": dict(device_operators="off",
                                solver_backend="tpu_cg"),
                "tpu_cg": dict(device_operators="off",
                               solver_backend="tpu_cg",
                               preconditioner="Jacobi")}


@pytest.mark.parametrize("route", sorted(FUSED_ROUTES))
def test_graph_solve_is_the_eager_solve(card, route, monkeypatch):
    """solve_fused=True (CUDA graphs, solver/fused.py) against the eager
    loops on 8 atoms, 2 cycles: the same bits and CG counts, and the ELL
    launches of the eager loop plus those of each cycle's warm-up; one
    capture per cycle, reused by every refinement pass."""
    from coulomb_gmg_tpu_torch.solver.fused import Segments
    captures = []
    plain = Segments._capture
    monkeypatch.setattr(Segments, "_capture",
                        lambda self: captures.append(self) or plain(self))
    out = {}
    for fused in (False, True):
        cfg = production_scaling_config(1, dtype="float32",
                                        n_adaptive_cycles=2,
                                        solve_fused=fused,
                                        **FUSED_ROUTES[route])
        sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                         pcout=Pcout(enabled=False))
        before = ell.ell_mv.launches
        res = sim.run()
        out[fused] = (sim.solution, [r["cg_iterations"] for r in res],
                      [r["cg_passes"] for r in res],
                      ell.ell_mv.launches - before)
        assert len(captures) == (2 if fused else 0)
    warmup = sum(s.warmup["launches"] for s in captures)
    assert np.array_equal(out[True][0], out[False][0])
    assert out[True][1:3] == out[False][1:3]
    assert warmup > 0 and out[True][3] == out[False][3] + warmup > warmup
    if route == "device_ops":
        assert max(len(p) for p in out[True][2]) >= 2


def test_capture_runs_without_the_collector(card, monkeypatch):
    """The graphs are captured with the cyclic collector off
    (solver/fused.py:Segments._capture): a collection in the middle of a
    capture could reset an earlier solve's graphs that wait in a reference
    cycle, which ends the capture (cudaErrorStreamCaptureInvalidated, seen
    on the H100).  The collector is on again afterwards."""
    import gc
    from coulomb_gmg_tpu_torch.solver.fused import Segments
    seen = []
    plain = Segments._capture_all
    monkeypatch.setattr(Segments, "_capture_all",
                        lambda self: seen.append(gc.isenabled())
                        or plain(self))
    cfg = production_scaling_config(1, dtype="float32", n_adaptive_cycles=1)
    first = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                       pcout=Pcout(enabled=False))
    first.run()
    junk = [first.gmg]
    junk.append(junk)                   # its graphs wait for the collector
    del first, junk
    res = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                     pcout=Pcout(enabled=False)).run()
    assert seen == [False, False] and gc.isenabled()
    assert res[0]["n_cells"] == 85184
    assert res[0]["residual"] <= 1.01e-8 * res[0]["l2_rhs"]


def test_sharded_graph_solve_is_the_eager_solve(card):
    """The 8-atom float64 SPMD run on 4 shards of cuda:0 with solve_fused
    off and on: the same bits and CG counts, the stepped ShardedGMG as
    CUDA graphs.  Then, on its last system, the eager and the graph solve
    from zero: equal bits, coarse iterations and norms, ELL launches of
    the eager loop plus the warm-up's, ``k + 1 + sum(kc + 1)`` reads."""
    out = {}
    for fused in (False, True):
        cfg = production_scaling_config(1, dtype="float64", n_devices=4,
                                        n_adaptive_cycles=2,
                                        solve_fused=fused)
        sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                         pcout=Pcout(enabled=False),
                         spmd_devices=["cuda:0"] * 4)
        res = sim.run()
        out[fused] = (sim.solution, [r["cg_iterations"] for r in res])
        assert sim.gmg.solve_info()["mode"] == (
            "stepped, CUDA graphs: 4 shards on cuda:0" if fused
            else "eager: host loops")
    assert np.array_equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    sg, rhs, got = sim.gmg, np.asarray(sim.rhs), {}
    for fused in (False, True):
        sg.fused = fused
        n0 = len(sg.coarse_iterations)
        before = ell.ell_mv.launches
        x, k, res0, res = sg.solve(rhs, None, rtol=1e-8)
        got[fused] = (x, k, res0, res, sg.coarse_iterations[n0:],
                      ell.ell_mv.launches - before, sg.solve_info())
    (xe, *e, le, ie), (xg, *g, lg, ig) = got[False], got[True]
    sg.release()
    assert np.array_equal(xg, xe) and g == e and 1 <= g[0] <= 20
    warm = ig["warmup"]["launches"]
    assert warm > 0 and lg == le + warm
    reads = g[0] + 1 + sum(kc + 1 for kc in g[3])
    assert ig["reads"] == ie["reads"] == reads


def test_sharded_jacobi_and_cg_graphs_are_the_eager_solves(card):
    """The sharded Jacobi-CG on 4 shards of cuda:0 and the one-device
    Jacobi CG, each eager and as CUDA graphs: the same bits and counts,
    one read per iteration and one of |rhs|."""
    from coulomb_gmg_tpu_torch.ops.smoothers import make_jacobi
    from coulomb_gmg_tpu_torch.ops.spmv import CSR
    from coulomb_gmg_tpu_torch.parallel.multihost import poisson_7pt
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    from coulomb_gmg_tpu_torch.solver.cg import cg
    from coulomb_gmg_tpu_torch.solver.fused import stepped_cg
    rows, cols, vals, n = poisson_7pt(12)
    ctx = SpmdContext(4, ["cuda:0"] * 4)
    A = ShardedCSR.from_coo(rows, cols, vals, n, 4)
    bnp = np.random.default_rng(7).standard_normal(n)
    b = put_blocks(shard_vector(bnp, 4), ctx)
    out = {}
    for fused in (False, True):
        solver = make_sharded_solver(ctx, A, sharded_diag(A, 4),
                                     tol_rtol=1e-10, maxiter=2000,
                                     fused=fused)
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        out[fused] = (torch.cat(xb), k, res0, res, solver.info)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1:4] == out[False][1:4]
    assert out[True][4]["mode"] == "stepped, CUDA graphs: 4 shards on " \
        "cuda:0"
    assert out[True][4]["reads"] == out[True][1] + 2
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    csr = CSR.from_pattern(indptr, cols[order], vals[order], device=card)
    bd = torch.from_numpy(bnp).to(card)
    M = make_jacobi(csr, 0.6)
    tol = 1e-10 * float(np.linalg.norm(bnp))
    e = cg(csr.matvec, bd, None, precond=M, tol=tol, maxiter=2000)
    s = stepped_cg(csr.matvec, bd, None, precond=M, tol=tol, maxiter=2000)
    assert torch.equal(s.x, e.x) and tuple(s)[1:] == tuple(e)[1:]


def test_kernels_run_on_their_operands_card(card):
    """With cuda:0 current, the ELL and exact-gradient kernels on operands
    on cuda:1 launch there (kernels.launch) and match their plain
    versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(rng.integers(0, 5000, (27, 5000),
                                         dtype=np.int32)).to(other)
    vals = torch.from_numpy(rng.standard_normal((27, 5000))).to(other)
    x = torch.from_numpy(rng.standard_normal(5000)).to(other)
    pts = torch.from_numpy(rng.random((4096, 3), np.float32)).to(other)
    atoms = torch.from_numpy(np.concatenate(
        [rng.random((64, 3), np.float32),
         rng.choice([-1.0, 1.0], (64, 1)).astype(np.float32)], 1)).to(other)
    with torch.cuda.device(0):
        y = ell.ell_mv(cols, vals, x)
        g = gr.exact_gradient(pts, atoms, R_C)
    torch.cuda.synchronize(other)
    assert y.device == g.device == other
    yp = ell.ell_mv_plain(cols, vals, x)
    assert float((y - yp).abs().max()) <= 1e-12 * float(yp.abs().max())
    gp = gr.exact_gradient_plain(pts, atoms, R_C)
    assert float((g - gp).abs().max()) <= 1e-4 * float(gp.abs().max())


def _ell_by_card():
    from coulomb_gmg_tpu_torch import kernels
    return {i: n for (what, i), n in kernels.LAUNCHES.items()
            if what == "ell_spmv"}


def test_sharded_solves_across_cards(card):
    """One shard on each of up to four cards, one process: the stepped
    sharded solves are CUDA graphs over all the cards ("stepped, CUDA
    graphs: N shards on N cards") and give the bits and counts of the
    eager loops and of the one-card graph solve of as many shards, for
    ShardedGMG through the 8-atom float64 SPMD run (the last solve's host
    reads too: the cards' coarse CGs run in lockstep, the stop read from
    the first) and for the sharded Jacobi-CG; the ELL kernel runs on every
    card."""
    from coulomb_gmg_tpu_torch.parallel.multihost import poisson_7pt
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
    n_cards = min(torch.cuda.device_count(), 4)
    if n_cards < 2:
        pytest.skip("needs two CUDA cards")
    devices = [f"cuda:{i}" for i in range(n_cards)]
    one_card = ["cuda:0"] * n_cards
    mode = f"stepped, CUDA graphs: {n_cards} shards on {n_cards} cards"
    modes = {"eager": "eager: host loops", "cards": mode,
             "one_card": f"stepped, CUDA graphs: {n_cards} shards on "
                         "cuda:0"}
    runs = {"eager": (devices, False), "cards": (devices, True),
            "one_card": (one_card, True)}
    out = {}
    for key, (spmd_devices, fused) in runs.items():
        cfg = production_scaling_config(1, dtype="float64",
                                        n_devices=n_cards,
                                        n_adaptive_cycles=2,
                                        solve_fused=fused)
        sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                         pcout=Pcout(enabled=False),
                         spmd_devices=spmd_devices)
        before = _ell_by_card()
        res = sim.run()
        info = sim.gmg.solve_info()
        out[key] = (sim.solution, [r["cg_iterations"] for r in res],
                    [r["coarse_cg"] for r in res], info["reads"])
        assert info["mode"] == modes[key]
        if key == "cards":
            after = _ell_by_card()
            assert all(after.get(i, 0) > before.get(i, 0)
                       for i in range(n_cards))
    for key in ("cards", "one_card"):
        assert np.array_equal(out[key][0], out["eager"][0])
        assert out[key][1:] == out["eager"][1:]
    rows, cols, vals, n = poisson_7pt(12)
    bnp = shard_vector(np.random.default_rng(7).standard_normal(n), n_cards)
    jac = {}
    for key, (spmd_devices, fused) in runs.items():
        ctx = SpmdContext(n_cards, spmd_devices)
        A = ShardedCSR.from_coo(rows, cols, vals, n, n_cards)
        b = put_blocks(bnp, ctx)
        solver = make_sharded_solver(ctx, A, sharded_diag(A, n_cards),
                                     tol_rtol=1e-10, maxiter=2000,
                                     fused=fused)
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        jac[key] = (torch.cat([x.cpu() for x in xb]), k, res0, res,
                    solver.info["reads"])
        assert solver.info["mode"] == modes[key].replace("host loops",
                                                          "host loop")
    for key in ("cards", "one_card"):
        assert torch.equal(jac[key][0], jac["eager"][0])
        assert jac[key][1:] == jac["eager"][1:]


def test_sharded_solves_across_nccl_ranks(card):
    """Two processes, one card each, joined by NCCL
    (parallel/multihost.py:launch, ``--fused``, the 2-atom problem): the
    stepped solves are CUDA graphs with the collectives captured on each
    rank's stream, and give the bits, counts and host reads of the rank's
    eager loops across the same processes and the bits of rank 0's
    one-process solves; a replayed collective has no seconds (null)."""
    from coulomb_gmg_tpu_torch.parallel.multihost import SEGMENTS, launch
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    a, b = lines = launch(["cuda:0", "cuda:1"], "nccl", "small", 600)
    for r in lines:
        assert r["gmg_mode"] == r["jacobi_mode"] == (
            "stepped, CUDA graphs: 2 processes (nccl)")
        assert r["eager_equal"] == {"jacobi": True, "gmg": True}
        assert r["gather_equal"] == {"jacobi": True, "gmg": True}
        assert r["gmg_warmup"]["launches"] > 0 and r["ell_launches"] > 0
        assert r["gmg_capture_s"] > 0 and r["jacobi_capture_s"] > 0
        assert list(r["gmg_replay_ms"]) == list(SEGMENTS)
        assert {"psum", "halo", "coarse"} <= set(r["comm_bytes"])
        assert all(v is None for v in r["comm_s"].values())
        assert r["gmg_reads"] == r["gmg_iters"] + 1 + sum(
            kc + 1 for kc in r["coarse_cg"])
    assert a["gmg_iters"] == b["gmg_iters"] and a["iters"] == b["iters"]
    assert a["gmg_checksum"] == b["gmg_checksum"]
    assert a["checksum"] == b["checksum"]
    assert a["one_process_equal"] == a["other_form_equal"] == {
        "jacobi": True, "gmg": True}


@pytest.mark.parametrize("config", ["gpu", "gpu_f64"])
def test_bench_on_card_8_atoms(card, config):
    """``python -m coulomb_gmg_tpu_torch.bench`` at 8 atoms, one timed
    run, on the card: a valid ``_gpu`` headline, the published cells and
    the path's kernels launched."""
    import json
    import os
    import subprocess
    import sys
    from coulomb_gmg_tpu_torch import bench
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, BENCH_N="1", BENCH_RUNS="1", PYTHONPATH=root)
    env.pop("BENCH_FE", None)
    p = subprocess.run([sys.executable, "-m", "coulomb_gmg_tpu_torch.bench",
                        "--config", config], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["metric"] == ("walltime_8atom_5cycle_production_gmg_s_"
                              + config)
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["power_limit_w"] > 0 and line["runs"] == 1
    rec = json.loads(next(ln for ln in lines
                          if ln.startswith(bench.RUN_TAG))[len(bench.RUN_TAG):])
    assert rec["cells"] == bench.REF_CELLS[8]
    assert all(rec["launches"][k] > 0 for k in bench.PATH_KERNELS[config])
    assert rec["peak_bytes"] > 0
