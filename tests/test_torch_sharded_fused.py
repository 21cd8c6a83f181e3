"""The stepped sharded solves of the PyTorch port (``solve_fused=True``, the
counterparts of the JAX package's one-executable ``ShardedGMG`` and sharded
Jacobi-CG) against the eager loops they replace, and against live JAX.

On the CPU every segment of a stepped solve runs eagerly, one call for each
replay the card makes, so these tests run the code that the card captures.
Each stepped solve must give its eager loop's bits: ``torch.equal`` on the
solution, equal iteration counts, coarse iterations per V-cycle and norms.

* ``ShardedGMG`` on the ``small_sim`` of tests/test_sharded_gmg.py at
  D = 1, 3 and 8, from zero and from a nonzero start, with the halo plan
  and with all-gather imports, and in float32; a zero right-hand side (0
  iterations) and a run that stops at ``maxiter``.  Host reads, counted by
  solver/cg.py:to_host, are ``k + 1 + sum(kc + 1)`` for k CG steps and the
  k + 1 V-cycles of kc coarse iterations each, in both forms;
* the sharded Jacobi-CG at D = 1, 3 and 8 (reads: ``k + 2``, the
  tolerance's ``|rhs|`` among them), the one-device Jacobi route
  (solver/fused.py:stepped_cg against solver/cg.py:cg) and both through
  the driver;
* the stepped ``ShardedGMG`` against JAX's live ``ShardedGMG`` at D = 3 on
  JAX's ``small_sim``: the same CG count, solution and residuals within
  rel 1e-12;
* ``SpmdContext.graph_mode`` for every topology, on fake device lists and
  a stand-in process group (no card needed), each with its mode string;
  a capture that fails raises out of the solve instead of running the
  segments uncaptured; the collectives' counts of a graph replay.
"""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import Config, golden_gaussian_config
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.models.atoms import two_atom_pair
from coulomb_gmg_tpu_torch.ops.smoothers import make_jacobi
from coulomb_gmg_tpu_torch.parallel.multihost import poisson_7pt
from coulomb_gmg_tpu_torch.parallel.sharded import (
    ShardedCSR, make_sharded_solver, put_blocks, shard_vector, sharded_diag)
from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
from coulomb_gmg_tpu_torch.parallel.spmd import SpmdContext
from coulomb_gmg_tpu_torch.solver.cg import cg, to_host
from coulomb_gmg_tpu_torch.solver.fused import Segments, stepped_cg
from coulomb_gmg_tpu_torch.utils.logging import Pcout

torch.set_num_threads(2)

SMALL = dict(n_adaptive_cycles=2, flag_output_time=False, mesh_size_h=0.5,
             vacuum_repetitions=4)


def ctx(D):
    return SpmdContext(D, ["cpu"] * D)


@pytest.fixture(scope="module")
def small_sim():
    sim = Simulation(golden_gaussian_config(**SMALL), atoms=two_atom_pair(),
                     device="cpu", pcout=Pcout(enabled=False))
    sim.run()
    # a nonzero start: half the one-shard solution of the last system
    sim.half = 0.5 * ShardedGMG(sim.gmg, sim.A, ctx(1), dtype=sim.dtype,
                                fused=False).solve(sim.rhs, rtol=1e-8)[0]
    return sim


def _gmg_both(sim, D, rhs, x0=None, **kw):
    """The eager and the stepped ShardedGMG on one right-hand side: per
    form (x, k, |r0|, |r|, coarse iterations, solve_info)."""
    out = {}
    for fused in (False, True):
        sg = ShardedGMG(sim.gmg, sim.A, ctx(D), fused=fused,
                        **{"maxiter": 50, "dtype": sim.dtype, **kw})
        x, k, res0, res = sg.solve(rhs, x0, rtol=1e-8)
        out[fused] = (x, k, res0, res, list(sg.coarse_iterations),
                      sg.solve_info())
        sg.release()
    return out


def _assert_same(out):
    e, s = out[False], out[True]
    assert np.array_equal(s[0], e[0])
    assert s[1:5] == e[1:5]


def _reads(k, coarse):
    return k + 1 + sum(kc + 1 for kc in coarse)


@pytest.mark.parametrize("halo", [True, False])
@pytest.mark.parametrize("start", ["zero", "half"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_stepped_sharded_gmg_is_the_eager_solve(small_sim, D, start, halo):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    x0 = None if start == "zero" else sim.half
    out = _gmg_both(sim, D, rhs, x0, halo=halo)
    _assert_same(out)
    x, k, res0, res, coarse, info = out[True]
    assert 1 <= k <= 20 and res <= 1e-8 * np.linalg.norm(rhs)
    assert len(coarse) == k + 1 and all(kc > 0 for kc in coarse)
    assert info["mode"] == "stepped, uncaptured: on the CPU"
    assert out[False][5]["mode"] == "eager: host loops"
    for form in out.values():
        assert form[5]["reads"] == _reads(k, coarse)


@pytest.mark.parametrize("D", [1, 3])
def test_stepped_sharded_gmg_float32(small_sim, D):
    """The float32 ShardedGMG (the SPMD path's float32 runs): the stepped
    form compares the float32 norm with the float32-rounded tolerance as
    the eager loop does, and gives its bits."""
    sim = small_sim
    out = _gmg_both(sim, D, np.asarray(sim.rhs), dtype=torch.float32)
    _assert_same(out)
    assert 1 <= out[True][1] <= 50
    assert out[True][5]["reads"] == _reads(out[True][1], out[True][4])


def test_stepped_sharded_gmg_zero_rhs_and_maxiter(small_sim):
    sim = small_sim
    n = sim.A.n_rows
    out = _gmg_both(sim, 3, np.zeros(n))
    _assert_same(out)
    x, k, res0, res, coarse, info = out[True]
    assert k == 0 and res0 == res == 0.0 and not x.any()
    assert coarse == [0] and info["reads"] == 1 + 1
    out = _gmg_both(sim, 3, np.asarray(sim.rhs), maxiter=2)
    _assert_same(out)
    assert out[True][1] == 2 and out[True][3] > 1e-8 * out[True][2]
    assert out[True][5]["reads"] == _reads(2, out[True][4])


def test_stepped_sharded_gmg_reuses_its_state(small_sim):
    """Two solves on one ShardedGMG (the state of the first left in
    place): the second gives the bits of a fresh eager solve."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    sg = ShardedGMG(sim.gmg, sim.A, ctx(3), dtype=sim.dtype, maxiter=50)
    sg.solve(rhs, rtol=1e-8)
    stepped = sg.stepped
    x, k = sg.solve(2.0 * rhs, rtol=1e-8)[:2]
    assert sg.stepped is stepped
    ref = ShardedGMG(sim.gmg, sim.A, ctx(3), dtype=sim.dtype, maxiter=50,
                     fused=False).solve(2.0 * rhs, rtol=1e-8)
    assert np.array_equal(x, ref[0]) and k == ref[1]
    sg.release()
    assert sg.stepped is None and stepped.segments.fns == {}


@pytest.mark.parametrize("D", [1, 3, 8])
def test_stepped_sharded_jacobi_is_the_eager_solve(D):
    rows, cols, vals, n = poisson_7pt(8)
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    c = ctx(D)
    b = put_blocks(shard_vector(np.random.default_rng(7).standard_normal(n),
                                D), c)
    out = {}
    for fused in (False, True):
        solver = make_sharded_solver(c, A, sharded_diag(A, D),
                                     tol_rtol=1e-10, maxiter=2000,
                                     fused=fused)
        xb, k, res0, res = solver(b, [torch.zeros_like(v) for v in b])
        out[fused] = (torch.cat(xb), k, res0, res, solver.info)
    e, s = out[False], out[True]
    assert torch.equal(s[0], e[0]) and s[1:4] == e[1:4]
    assert 10 <= s[1] < 2000 and s[3] < 1e-10 * np.linalg.norm(
        torch.cat(b).numpy())
    assert s[4]["reads"] == e[4]["reads"] == s[1] + 2
    assert s[4]["mode"] == "stepped, uncaptured: on the CPU"


def test_stepped_sharded_jacobi_maxiter():
    rows, cols, vals, n = poisson_7pt(6)
    A = ShardedCSR.from_coo(rows, cols, vals, n, 3)
    c = ctx(3)
    b = put_blocks(shard_vector(np.ones(n), 3), c)
    out = []
    for fused in (False, True):
        out.append(make_sharded_solver(c, A, sharded_diag(A, 3),
                                       tol_rtol=1e-10, maxiter=3,
                                       fused=fused)(b, b))
    assert out[0][1] == out[1][1] == 3
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))


@pytest.mark.parametrize("maxiter", [0, 5, 500])
def test_stepped_cg_is_solver_cg(small_sim, maxiter):
    """The one-device Jacobi CG: solver/fused.py:stepped_cg against the
    eager solver/cg.py:cg, deal.II's stopping rule included (one
    iteration at ``maxiter`` 0, as the eager loop makes it)."""
    A = small_sim.A
    b = torch.from_numpy(np.asarray(small_sim.rhs))
    x0 = 0.1 * b
    M = make_jacobi(A, 0.6)
    tol = 1e-8 * float(torch.linalg.vector_norm(b))
    out = []
    for solve in (cg, stepped_cg):
        r0 = to_host.reads
        res = solve(A.matvec, b, x0, precond=M, tol=tol, maxiter=maxiter)
        out.append((res, to_host.reads - r0))
    (e, re), (s, rs) = out
    assert torch.equal(s.x, e.x) and tuple(s)[1:] == tuple(e)[1:]
    assert rs == re == s.iterations + 1
    assert s.iterations == max(maxiter, 1) or s.final_residual < tol
    zero = stepped_cg(A.matvec, 0 * b, None, precond=M, tol=1e-30,
                      maxiter=10)
    assert zero.iterations == 0 and not zero.x.any()


def test_segments_capture_follows_the_topology():
    """The stepped sharded solves capture only where every local shard is
    on a card (:func:`test_graph_mode_by_topology` has each topology);
    the choice is made before the solve."""
    assert SpmdContext(2, ["cpu"] * 2).graph_mode() == (
        False, "stepped, uncaptured: on the CPU")
    assert SpmdContext(2, ["cpu", "meta"]).graph_mode() == (
        False, "stepped, uncaptured: 2 devices, not all of them cards")
    assert Segments({}, "cpu").capture is False
    assert Segments({}, "cuda:0", capture=False).capture is False
    assert Segments({}, "cuda:0").capture is True


class _Group:
    """A stand-in for a process group: its size, this rank and the
    backend's name."""

    def __init__(self, size, rank, backend):
        self._size, self._rank, self.backend = size, rank, backend

    def size(self):
        return self._size

    def rank(self):
        return self._rank


TOPOLOGIES = {
    "one_card": (4, ["cuda:0"] * 4, None,
                 (True, "stepped, CUDA graphs: 4 shards on cuda:0")),
    "cards": (4, [f"cuda:{i}" for i in range(4)], None,
              (True, "stepped, CUDA graphs: 4 shards on 4 cards")),
    "two_shards_a_card": (4, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], None,
                          (True, "stepped, CUDA graphs: 4 shards on 2 "
                           "cards")),
    "cards_without_peer_access": (
        3, ["cuda:0", "cuda:5", "cuda:1"], None,
        (False, "stepped, uncaptured: 3 cards without peer access "
         "(cuda:0 -> cuda:5, cuda:5 -> cuda:0, cuda:5 -> cuda:1, "
         "cuda:1 -> cuda:5)")),
    "cpu": (3, ["cpu"] * 3, None, (False, "stepped, uncaptured: on the CPU")),
    "cpu_and_cards": (3, ["cpu", "cuda:0", "cuda:1"], None,
                      (False, "stepped, uncaptured: 3 devices, not all of "
                       "them cards")),
    "gloo_cpu": (4, ["cpu"] * 2, ("gloo", 2, 1),
                 (False, "stepped, uncaptured: 2 processes (gloo)")),
    "gloo_one_card": (4, ["cuda:0"] * 2, ("gloo", 2, 0),
                      (False, "stepped, uncaptured: 2 processes (gloo)")),
    "nccl": (8, ["cuda:2"] * 2, ("nccl", 4, 2),
             (True, "stepped, CUDA graphs: 4 processes (nccl)")),
}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_graph_mode_by_topology(monkeypatch, topology):
    """``SpmdContext.graph_mode`` on fake device lists (no card needed):
    captured for D shards on one card, on several cards that can read
    each other's memory, and on NCCL ranks; uncaptured, with the reason,
    for CPU shards, CPU and cards mixed, cards without peer access
    (any pair with cuda:5 here) and gloo."""
    import coulomb_gmg_tpu_torch.parallel.spmd as spmd
    D, devices, group, expected = TOPOLOGIES[topology]
    monkeypatch.setattr(spmd, "resolve", torch.device)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: 5 not in (torch.device(a).index,
                                               torch.device(b).index))
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda g: g.backend)
    g = None if group is None else _Group(group[1], group[2], group[0])
    ctx = SpmdContext(D, devices, group=g)
    assert ctx.graph_mode() == expected
    if g is not None:
        assert ctx.shards == list(range(group[2] * D // group[1],
                                        (group[2] + 1) * D // group[1]))


def _forced_capture(monkeypatch):
    """graph_mode says capture on the CPU shards, and every capture
    fails."""
    def fail(self):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(SpmdContext, "graph_mode",
                        lambda self: (True, "stepped, CUDA graphs: forced"))
    monkeypatch.setattr(Segments, "_capture_all", fail)


@pytest.mark.parametrize("solver", ["gmg", "jacobi"])
def test_a_failed_capture_raises(small_sim, monkeypatch, solver):
    """A capture that fails raises out of the solve; the segments never
    run uncaptured in its place (no host read, no iteration)."""
    _forced_capture(monkeypatch)
    reads = to_host.reads
    with pytest.raises(RuntimeError, match="capture failed"):
        if solver == "gmg":
            sg = ShardedGMG(small_sim.gmg, small_sim.A, ctx(3),
                            dtype=small_sim.dtype, maxiter=50)
            sg.solve(np.asarray(small_sim.rhs), rtol=1e-8)
        else:
            rows, cols, vals, n = poisson_7pt(6)
            A = ShardedCSR.from_coo(rows, cols, vals, n, 3)
            c = ctx(3)
            b = put_blocks(shard_vector(np.ones(n), 3), c)
            make_sharded_solver(c, A, sharded_diag(A, 3), tol_rtol=1e-10,
                                maxiter=100)(b, b)
    # the Jacobi-CG reads |rhs| for its tolerance before the first segment
    assert to_host.reads - reads == (0 if solver == "gmg" else 1)
    if solver == "gmg":
        assert sg.coarse_iterations == []


def test_comm_stats_of_replays():
    """Collectives run by a graph replay are counted with their bytes, and
    their kind's seconds become None (not measurable inside a replay);
    later timed calls leave it None."""
    from coulomb_gmg_tpu_torch.parallel.spmd import CommStats
    s = CommStats()
    s.add("psum", 16, 0.5)
    s.add("halo", 100, 0.25)
    s.replayed({"psum": 2}, {"psum": 32})
    s.add("psum", 16, 0.5)
    assert s.calls == {"psum": 4, "halo": 1}
    assert s.bytes == {"psum": 64, "halo": 100}
    assert s.seconds == {"psum": None, "halo": 0.25}


@pytest.mark.parametrize("route", ["spmd_gmg", "spmd_jacobi", "jacobi"])
def test_driver_routes_stepped_and_eager(route):
    """The driver's sharded GMG, sharded Jacobi and one-device Jacobi
    routes with ``solve_fused`` on and off: the same bits and counts."""
    out = {}
    for fused in (False, True):
        if route == "jacobi":
            cfg = Config(problem="Step16", dim=2, n_global_refinements=3,
                         domain_left=-1.0, domain_right=1.0,
                         n_adaptive_cycles=2,
                         boundary_conditions="Homogeneous",
                         preconditioner="Jacobi", flag_output_time=False,
                         cg_max_iters=500, solve_fused=fused)
            sim = Simulation(cfg, device="cpu", pcout=Pcout(enabled=False))
        else:
            cfg = golden_gaussian_config(
                **{**SMALL, "n_adaptive_cycles": 1}, n_devices=3,
                solve_fused=fused,
                preconditioner="GMG" if route == "spmd_gmg" else "Jacobi")
            sim = Simulation(cfg, atoms=two_atom_pair(), device="cpu",
                             pcout=Pcout(enabled=False),
                             spmd_devices=["cpu"] * 3)
        res = sim.run()
        out[fused] = (sim.solution, [r["cg_iterations"] for r in res],
                      [r["residual"] for r in res])
    assert np.array_equal(out[True][0], out[False][0])
    assert out[True][1:] == out[False][1:]
    assert all(k > 0 for k in out[True][1])


@pytest.fixture(scope="module")
def jax_small_sim():
    """The ``small_sim`` of tests/test_sharded_gmg.py, run by JAX."""
    from coulomb_gmg_tpu.config import golden_gaussian_config as jcfg
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.models.atoms import two_atom_pair as jpair
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    sim = JaxSimulation(jcfg(**SMALL), atoms=jpair(),
                        pcout=JaxPcout(enabled=False))
    sim.run()
    return sim


def test_stepped_sharded_gmg_matches_jax(small_sim, jax_small_sim):
    """The stepped ShardedGMG on the port's operators and JAX's ShardedGMG
    (one shard_map executable) on JAX's, D = 3, both given JAX's
    right-hand side."""
    import jax
    from jax.sharding import Mesh
    from coulomb_gmg_tpu.parallel.sharded_gmg import ShardedGMG as JaxGMG
    js = jax_small_sim
    rhs = np.asarray(js.rhs)
    mesh = Mesh(np.array(jax.devices()[:3]), ("shard",))
    xj, kj, res0j, resj = JaxGMG(js.gmg, js.A, mesh, dtype=js.dtype,
                                 maxiter=50).solve(rhs, rtol=1e-8)
    sg = ShardedGMG(small_sim.gmg, small_sim.A, ctx(3),
                    dtype=small_sim.dtype, maxiter=50)
    x, k, res0, res = sg.solve(rhs, rtol=1e-8)
    assert sg.solve_info()["mode"].startswith("stepped")
    assert k == kj
    assert res0 == pytest.approx(float(res0j), rel=1e-12)
    assert res == pytest.approx(float(resj), rel=1e-12)
    xj = np.asarray(xj)
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) < 1e-12
