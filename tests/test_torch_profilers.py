"""The port's kernel benchmark and profilers on the CPU at tiny sizes:
``bench_kernels``, ``profile_pieces``, ``profile_enorm`` and
``profile_setup`` (coulomb_gmg_tpu_torch/), each against what it
measures: the rows' keys and bounds, the driver's solve, the FE-error
loop of postprocess/energy.py and the JAX package's assembly plan.  On
the card they run in ``chip_smoke.py``'s tools phase."""

import importlib

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch import (bench_kernels, profile_enorm,
                                   profile_pieces, profile_setup, roofline)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = ["--sizes", "8", "--points", "256", "--side", "8"]


@pytest.fixture(scope="module")
def kernel_rows():
    return bench_kernels.main(SMALL + ["--device", "cpu", "--json"])


def test_bench_kernels_rows_carry_every_key(kernel_rows):
    rows = [r for r in kernel_rows if "kernel" in r]
    assert [r["kernel"] for r in rows] == [
        "tile_density", "dense_density", "exact_gradient", "ell_spmv",
        "ell_spmv_padded", "spmv_csr"]
    for r in rows:
        assert set(bench_kernels.KEYS) <= set(r), r
        # on the CPU the wrapper runs the plain version: the same function
        assert r["max_err"] == 0.0 and r["pass"] and r["launches"] == 0
        assert r["device"] == "cpu" and r["ms"] > 0 and r["plain_ms"] > 0
        assert r["share"] == r["bound_ms"] / r["ms"]
    assert all(r["library_ms"] > 0 for r in rows[3:])
    assert all(r["library_ms"] is None for r in rows[:3])
    solvers = [r for r in kernel_rows if "solver" in r]
    assert [r["solver"] for r in solvers] == ["jacobi_cg", "chebyshev_cg"]
    assert all(r["iterations"] > 0 and r["rel_residual"] <= 1e-6
               and r["converged"] for r in solvers)


def test_bench_kernels_bounds_are_the_rooflines(kernel_rows):
    """Each row's bound is roofline.py's for the inputs the row used,
    rebuilt here from the same seed."""
    rows = {r["kernel"]: r for r in kernel_rows if "kernel" in r}
    rng = np.random.default_rng(0)        # tile rows draw nothing
    args, kw = bench_kernels.dense_inputs(8, 256, rng, CPU)
    from coulomb_gmg_tpu_torch.ops import density as dd, gradient as gr
    b = roofline.dense_density(args, kw, dd.dense_density(*args, **kw))
    assert rows["dense_density"]["bound_ms"] == b["bound_ms"]
    pts, atoms = bench_kernels.gradient_inputs(8, 256, rng, CPU)
    b = roofline.exact_gradient(pts, atoms, gr.far_r2(bench_kernels.R_C))
    assert rows["exact_gradient"]["bound_ms"] == b["bound_ms"]
    # the 8^3 7-point matrix: 3,200 nonzeros, one FMA, a column and a value
    # each; x read and y written, float32
    nnz, n = 7 * 8 ** 3 - 6 * 8 ** 2, 8 ** 3
    b = roofline.bound(2 * nnz, 8 * nnz + 2 * 4 * n)
    for k in ("ell_spmv", "ell_spmv_padded", "spmv_csr"):
        assert rows[k]["bound_ms"] == b["bound_ms"]
        assert rows[k]["size"] == n


def test_bench_kernels_tile_row_is_the_production_plan(kernel_rows):
    from coulomb_gmg_tpu_torch.config import production_scaling_config
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
    from coulomb_gmg_tpu_torch.ops import tile_density as td
    cfg = production_scaling_config(1, dtype="float32")
    atoms = nacl_lattice(1)
    sim = Simulation(cfg, atoms=atoms, device="cpu")
    f = sim.make_initial_mesh()
    cut = cfg.nonzero_radius * cfg.r_c
    plan = td.build_tile_plan(f, len(sim.tab_rhs.points), atoms.positions,
                              atoms.charges, cut, n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, sim.tab_rhs.points, plan, cfg.r_c, cut,
                                CPU)
    kw["n_out"] = f.n_cells + 1
    b = roofline.tile_density(args, kw, td.tile_density(*args, **kw))
    row = next(r for r in kernel_rows if r.get("kernel") == "tile_density")
    assert row["bound_ms"] == b["bound_ms"] and row["size"] == 8
    with pytest.raises(ValueError, match="8 n"):
        bench_kernels.lattice_n(9)


@pytest.fixture(scope="module")
def pieces():
    return profile_pieces.run(1, 1, CPU)


def test_profile_pieces_eager_solve_is_the_drivers(pieces):
    """Cycle 0 of the 8-atom device-operator run: the profile's eager
    solve from zero has the driver's CG passes and its solution, bit for
    bit (the driver's solve is the stepped one, whose bits are the eager
    loop's)."""
    from coulomb_gmg_tpu_torch.fem.constraints import distribute
    sim = profile_pieces.system(1, 1, CPU, "on")
    res = sim.results[-1]
    solves = {r["solve"]: r for r in pieces["records"] if "solve" in r}
    assert set(solves) == {"eager", "stepped_cold", "stepped_hot"}
    for r in solves.values():
        assert r["cg"] == res["cg_iterations"]
        assert r["passes"] == res["cg_passes"]
    np.testing.assert_array_equal(
        distribute(sim.constraints, pieces["x_eager"]), sim.solution)
    host = [r for r in pieces["records"] if "host_solve" in r]
    assert [r["host_solve"] for r in host] == [
        "build", "rebuild", "eager", "stepped_cold", "stepped_hot"]
    assert len({r["cg"] for r in host[2:]}) == 1


def test_profile_pieces_matvec_forms_agree(pieces):
    mv = {r["matvec"]: r for r in pieces["records"] if "matvec" in r}
    assert set(mv) == {"cellwise", "ell_sliced", "ell_padded"}
    assert mv["cellwise"]["max_rel_diff"] == 0.0
    assert mv["ell_sliced"]["max_rel_diff"] < 1e-5
    assert mv["ell_padded"]["max_rel_diff"] == mv["ell_sliced"][
        "max_rel_diff"]
    assert all(r["graph_ms"] is None for r in mv.values())


@pytest.mark.parametrize("cycles", [1, 3])
def test_profile_pieces_lists_every_level(cycles):
    out = profile_pieces.run(1, cycles, CPU)
    recs = out["records"]
    (sysrec,) = [r for r in recs if "system" in r]
    L = sysrec["levels"]
    assert L == len(out["sim"].gmg.ops["levels"])
    assert (L > 1) == (cycles > 1)
    levels = {r["level"] for r in recs if "piece" in r} - {None}
    assert levels == set(range(L))
    names = {r["piece"] for r in recs if "piece" in r}
    for l in range(1, L):
        assert {f"L{l} {k}" for k in ("A", "cheb", "R", "P", "down",
                                      "up")} <= names
    (check,) = [r for r in recs if "check" in r]
    assert check["pieces"] == (["copy_to", "coarse", "copy_back"]
                               + [f"L{l} {h}" for l in range(1, L)
                                  for h in ("down", "up")])
    assert check["eager_sum_ms"] > 0 and "graph_sum_ms" not in check


def _enorm_case():
    from coulomb_gmg_tpu_torch.mesh.forest import Forest
    rng = np.random.default_rng(3)
    f = Forest.uniform(3, 4, np.zeros(3), 0.5)
    f = f.refine(rng.random(f.n_cells) < 0.3)
    u = rng.standard_normal(f.dofs_of(1).n_dofs)
    pos = rng.uniform(0.2, 1.8, (6, 3))
    q = rng.choice([-1.0, 1.0], 6)
    return f, u, pos, q


def test_profile_enorm_loop_is_energy_norm_error():
    """The profiler's loop on a mesh's own DoF values, sizes and corners
    gives postprocess/energy.py's error, float64, to rel 1e-12."""
    from coulomb_gmg_tpu_torch.ops.density import pack_atoms
    from coulomb_gmg_tpu_torch.ops.gradient import exact_gradient_plain
    from coulomb_gmg_tpu_torch.ops.q1 import element_tables
    from coulomb_gmg_tpu_torch.postprocess.energy import energy_norm_error
    f, u, pos, q = _enorm_case()
    tab = element_tables(3, 1, 2)
    mesh = {"ucell": u[f.dofs_of(1).cell2dof], "h": f.cell_h(),
            "lower": f.cell_lower()}
    got = profile_enorm.loop_error_sq(
        profile_enorm.to_device(mesh, CPU, torch.float64), tab,
        pack_atoms(pos, q, CPU, torch.float64), 7, exact_gradient_plain)
    ref = energy_norm_error(f, tab, u, pos, q, profile_enorm.R_C, CPU,
                            dtype=torch.float64)
    assert abs(float(got) ** 0.5 / ref - 1) < 1e-12


def test_profile_enorm_records():
    recs = profile_enorm.main(["--device", "cpu", "--atoms", "64",
                               "--chunks", "3", "--chunk", "32"])
    by = {r["measure"]: r for r in recs}
    assert list(by) == ["h2d_atoms", "h2d_mesh", "grad_standalone",
                        "enorm_loop", "enorm_loop_plain"]
    assert by["grad_standalone"]["pairs"] == 32 * 8 * 64
    assert by["enorm_loop"]["pairs"] == 3 * 32 * 8 * 64
    # on the CPU the kernel's wrapper is the plain version
    assert by["enorm_loop_plain"]["rel_vs_kernel"] == 0.0
    for k in ("grad_standalone", "enorm_loop", "enorm_loop_plain"):
        r = by[k]
        assert r["bound_by"] in ("bytes", "operations") and r["share"] > 0
        assert r["device"] == "cpu"


@pytest.mark.parametrize("dim, reps, seed", [(3, 6, 1), (2, 12, 0)])
def test_profile_setup_counts_match_jax(dim, reps, seed):
    """The pattern's nonzeros and the clean and dirty counts of the
    profiled plan equal the JAX package's build_plan on the same forest
    (two refinements with seeded marks: hanging nodes, dirty cells)."""
    from coulomb_gmg_tpu.fem.assembly import build_plan as jax_plan
    from coulomb_gmg_tpu.fem.constraints import (build_constraints as
                                                 jax_constraints)
    from coulomb_gmg_tpu.mesh import forest as JM
    from coulomb_gmg_tpu_torch.mesh import forest as TM

    def forest(pkg):
        f = pkg.Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
        rng = np.random.default_rng(seed)
        for _ in range(2):
            f = f.refine(rng.random(f.n_cells) < 0.2)
        return f

    got = profile_setup.profile(forest(TM), 1, None)
    jf = forest(JM)
    plan = jax_plan(jf.dofs.cell2dof, jax_constraints(jf.dofs, None))
    assert got["nnz"] == plan.pattern.nnz
    assert got["clean"] == len(plan.clean_idx) < got["n_cells"]
    assert got["n_cells"] == plan.n_cells == jf.n_cells
    assert got["dirty_m"] == len(plan.md_cell) > 0
    assert {"card_constraints", "_expand (dirty)",
            "card_assembly.plan TOTAL"} <= set(got["seconds"])


@pytest.mark.parametrize("module, argv", [
    ("rc_sweep", ["--reps", "2"]), ("bench_kernels", SMALL),
    ("profile_pieces", ["--n", "1"]), ("profile_enorm", ["--atoms", "8"]),
    ("profile_setup", ["1"]), ("profile_topology", ["--n", "1"])])
def test_entry_points_need_the_card(module, argv):
    """Without ``--device cpu`` each entry point takes the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"coulomb_gmg_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
