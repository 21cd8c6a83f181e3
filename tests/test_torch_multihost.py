"""The port's sharded solvers across processes on the CPU, the counterpart
of tests/test_multihost.py.

Two worker processes of ``coulomb_gmg_tpu_torch.parallel.multihost``, 2
shards each, joined by a gloo ``torch.distributed`` group: every ``psum``,
coarse gather and halo import crosses the process boundary.  They must
agree with each other (iterations, bitwise checksums, different local
halves), with the one-process 4-shard port (``torch.equal``, reported by
rank 0), with their own all-gather imports (``torch.equal``), and with the
JAX package's one-process 4-device solves run live here: the same counts,
checksums within the JAX test's own tolerances (rel 1e-12 for Jacobi, 1e-10
for GMG, tests/test_multihost.py:120, :167).  Also: the NCCL card mapping,
the pipeline stages that raise across processes, and the CLI under
``--distributed``.
"""

import sys

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import production_scaling_config
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.parallel.multihost import (env_with_root, launch,
                                                      poisson_7pt, run_ranks)
from coulomb_gmg_tpu_torch.parallel.spmd import (SpmdContext,
                                                 electrostatic_energy_spmd)
from coulomb_gmg_tpu_torch.utils.platform import (init_distributed,
                                                  nccl_device)

torch.set_num_threads(2)

TIMEOUT = 300


@pytest.fixture(scope="module")
def workers():
    return launch(["cpu", "cpu"], "gloo", "small", TIMEOUT)


def test_a_failed_worker_stops_the_run():
    """Rank 1 cannot start (no such card here): rank 0, waiting for it in
    the rendezvous, is killed, and the run raises with rank 1's error."""
    if torch.cuda.device_count() > 7:
        pytest.skip("cuda:7 exists")
    with pytest.raises(RuntimeError, match="rank 1: exit 1"):
        launch(["cpu", "cuda:7"], "gloo", "small", TIMEOUT)


def test_a_taken_port_is_tried_once_more(tmp_path):
    """A rank that finds its rendezvous port taken fails the attempt; the
    ranks then run once more on another port."""
    mark = tmp_path / "tried"
    script = ("import pathlib, sys\n"
              f"p = pathlib.Path({str(mark)!r})\n"
              "if not p.exists():\n"
              "    p.write_text('x')\n"
              "    sys.exit('EADDRINUSE: address already in use')\n"
              "print(sys.argv[1])\n")
    ports = []

    def command(r, port):
        ports.append(port)
        return [sys.executable, "-c", script, str(port)], env_with_root()

    outs = run_ranks(command, 1, TIMEOUT)
    assert [rc for rc, _, _ in outs] == [0]
    assert len(ports) == 2 and outs[0][1].strip() == str(ports[1])


def test_four_shards_span_two_processes(workers):
    a, b = workers
    assert a["devices"] == b["devices"] == 4
    assert (a["rank"], a["shards"]) == (0, [0, 1])
    assert (b["rank"], b["shards"]) == (1, [2, 3])
    # every kind of collective crossed the process boundary
    for r in workers:
        assert {"psum", "halo", "coarse"} <= set(r["comm_bytes"])
        assert all(v > 0 for v in r["comm_bytes"].values())


def test_jacobi_cg_across_processes(workers):
    a, b = workers
    assert a["iters"] == b["iters"] > 0
    assert a["rel_res"] <= 1e-10 and b["rel_res"] <= 1e-10
    assert a["checksum"] == b["checksum"]
    assert a["local_norm"] != b["local_norm"]
    assert a["one_process_equal"]["jacobi"] is True


def test_sharded_gmg_across_processes(workers):
    a, b = workers
    assert 1 <= a["gmg_iters"] <= 20 and a["gmg_iters"] == b["gmg_iters"]
    assert a["gmg_rel_res"] <= 1.01e-8
    assert a["gmg_true_rel_res"] <= 1.01e-8
    assert a["gmg_checksum"] == b["gmg_checksum"]
    assert a["gmg_local_norm"] != b["gmg_local_norm"]
    assert a["vcycles"] == a["gmg_iters"] + 1 == len(a["coarse_cg"])
    assert a["one_process_equal"]["gmg"] is True


@pytest.mark.parametrize("solver", ["jacobi", "gmg"])
def test_all_gather_import_gives_the_halo_bits(workers, solver):
    for r in workers:
        assert r["gather_equal"][solver] is True


def test_jacobi_cg_matches_jax(workers):
    """The JAX package's one-process 4-device sharded Jacobi-CG on the
    same matrix and right-hand side."""
    import jax
    from jax.sharding import Mesh
    from coulomb_gmg_tpu.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    rows, cols, vals, n = poisson_7pt(12)
    D = 4
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    b = np.random.default_rng(7).standard_normal(n)
    solver = make_sharded_solver(mesh, A, sharded_diag(A, D),
                                 tol_rtol=1e-10, maxiter=2000, damping=0.6)
    rhs = put_blocks(shard_vector(b, D), mesh)
    xb, k, _, _ = solver(rhs, rhs * 0.0)
    a = workers[0]
    assert int(k) == a["iters"]
    assert a["checksum"] == pytest.approx(
        float(np.sum(np.asarray(xb) ** 2)), rel=1e-12)


def test_sharded_gmg_matches_jax(workers):
    """JAX's ``ShardedGMG.solve_global`` on 4 devices of one process, on
    its own run of the same 2-atom golden problem."""
    import jax
    from jax.sharding import Mesh
    from coulomb_gmg_tpu.config import golden_gaussian_config
    from coulomb_gmg_tpu.driver import Simulation
    from coulomb_gmg_tpu.models.atoms import two_atom_pair
    from coulomb_gmg_tpu.parallel.sharded_gmg import ShardedGMG
    from coulomb_gmg_tpu.utils.logging import Pcout
    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50)
    xg, k, _, _ = sg.solve_global(np.asarray(sim.rhs), rtol=1e-8)
    a = workers[0]
    assert a["n_dofs"] == sim.A.n_rows
    assert int(k) == a["gmg_iters"]
    assert a["gmg_checksum"] == pytest.approx(
        float(np.sum(np.asarray(xg) ** 2)), rel=1e-10)


# ---------------------------------------------------------------------------
# process bring-up
# ---------------------------------------------------------------------------

def test_nccl_shared_card_mapping_raises():
    """NCCL puts local rank r on cuda:r; a rank without a card of its own
    would share one, which NCCL refuses: the mapping raises and names
    it."""
    assert nccl_device(1, 2) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="share cuda:0 with local rank 0"):
        nccl_device(1, 1)
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        nccl_device(0, 0)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="backend='gloo'"):
            init_distributed(init_method="tcp://127.0.0.1:1", world_size=2,
                             rank=1, backend="nccl", device="cuda:0",
                             local_rank=1)


def test_backend_is_named_for_cpu_tensors():
    """No default backend for CPU tensors: the caller names gloo."""
    with pytest.raises(ValueError, match="ask for backend='gloo'"):
        init_distributed(init_method="tcp://127.0.0.1:1", world_size=2,
                         rank=0, device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        init_distributed(init_method="tcp://127.0.0.1:1", world_size=2,
                         rank=0, backend="mpi", device="cpu")


class _TwoRanks:
    """A stand-in for a 2-rank process group: the stages raise before any
    collective."""

    def size(self):
        return 2

    def rank(self):
        return 1


@pytest.mark.parametrize("stage, n_args", [
    ("density", 5), ("density_tiles", 6), ("energy_norm_error", 6),
    ("estimate", 3), ("build_assembler", 4),
    ("electrostatic_energy_spmd", 5)])
def test_pipeline_stages_raise_across_processes(stage, n_args):
    ctx = SpmdContext(4, ["cpu"] * 2, group=_TwoRanks())
    assert ctx.shards == [2, 3] and ctx.W == 2
    fn = (lambda *a: electrostatic_energy_spmd(ctx, *a)) \
        if stage == "electrostatic_energy_spmd" else getattr(ctx, stage)
    with pytest.raises(NotImplementedError, match="one process only"):
        fn(*([None] * n_args))


def test_context_checks_the_shard_split():
    with pytest.raises(ValueError, match="do not split"):
        SpmdContext(3, ["cpu"], group=_TwoRanks())
    with pytest.raises(ValueError, match="2 shards"):
        SpmdContext(4, ["cpu"] * 4, group=_TwoRanks())


def test_simulation_with_shards_across_processes_raises(monkeypatch):
    from coulomb_gmg_tpu_torch import driver
    monkeypatch.setattr(driver, "world_size", lambda: 2)
    cfg = production_scaling_config(1, dtype="float64", n_devices=2)
    with pytest.raises(NotImplementedError, match="across 2 processes"):
        driver.Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                          spmd_devices=["cpu"] * 2)


def _cli(world, *extra):
    """The CLI's ranks under the torchrun environment."""
    env = {k: v for k, v in env_with_root().items()
           if not k.startswith(("JAX", "XLA"))}
    return run_ranks(lambda r, port: (
        [sys.executable, "-m", "coulomb_gmg_tpu_torch.cli", "--production",
         "1", "--device", "cpu", "--cycles", "1", "--distributed", *extra],
        env | dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))),
        world, TIMEOUT)


@pytest.mark.parametrize("world", [1, 2])
def test_cli_distributed(world):
    """``--distributed`` under the torchrun environment: every rank runs,
    rank 0 prints the reference's log, the others print nothing."""
    outs = _cli(world)
    for rc, out, err in outs:
        assert rc == 0, err
    log = outs[0][1]
    assert "Number of atoms: 8" in log and log.count("Cycle ") == 1
    assert "Number of active cells:       85184" in log
    assert "CG converged in" in log
    for _, out, _ in outs[1:]:
        assert out == ""


def test_cli_distributed_profile_is_one_file_a_rank(tmp_path):
    """``--profile`` under ``--distributed``: each rank writes its own
    trace, so no two ranks write one file."""
    outs = _cli(2, "--profile", str(tmp_path))
    for rc, out, err in outs:
        assert rc == 0, err
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "trace.rank0.json", "trace.rank1.json"]
