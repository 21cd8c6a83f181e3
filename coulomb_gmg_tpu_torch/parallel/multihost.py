"""One worker process of a multi-process sharded solve.

    python -m coulomb_gmg_tpu_torch.parallel.multihost <rank> <world> <port>
        [--device cpu|cuda:N] [--backend gloo|nccl] [--problem small|8k]
        [--fused | --no-fused]

The port of tests/multihost_worker.py: ``world`` processes, each owning 2
shards of a ``D = 2 * world`` shard ``SpmdContext``, joined into one
``torch.distributed`` group at ``tcp://127.0.0.1:<port>``
(utils/platform.py:init_distributed), so every ``psum``, coarse gather and
halo import of the sharded solvers crosses the process boundary, as the
reference's ``mpirun -np N`` runs cross nodes (run.sh:13).  Each rank runs
the JAX worker's two solves:

1. the sharded Jacobi-CG (parallel/sharded.py) on a 12^3 7-point Poisson
   matrix at rtol 1e-10;
2. ``ShardedGMG`` (parallel/sharded_gmg.py) at rtol 1e-8 on the last
   cycle's system of a single-device ``Simulation`` that every rank runs
   (the problem is replicated, only the solve is distributed):
   ``--problem small`` is the 2-atom golden problem after 2 cycles
   (``golden_gaussian_config(n_adaptive_cycles=2, mesh_size_h=0.5,
   vacuum_repetitions=4)``), ``--problem 8k`` the 8,000-atom float64
   host-assembled study after 3 cycles
   (``production_scaling_config(10, dtype="float64",
   n_adaptive_cycles=3)``, cycle 2's system).

Both solves run in the stepped form (``--fused``, the default: the
driver's ``solve_fused``; under NCCL its segments are CUDA graphs with the
collectives captured on the rank's stream, under gloo they run
uncaptured, one call a replay) or as the eager loops (``--no-fused``);
the line says which (``fused``, and each solver's ``mode``).  In the
stepped form each rank then runs the eager loops across the same
processes and reports whether they gave the same bits, counts and host
reads (``eager_equal``).  Each solve runs with the
halo plan and again with ``halo=False`` (every import an all-gather); both
must give the same bits.  Rank 0 then runs the one-process D-shard solves
of the same systems, in the same form and in the other, and reports
whether they are ``torch.equal`` to the multi-process ones.  Every rank
prints one JSON line: the JAX worker's keys (``devices``, ``iters``,
``rel_res``,
``checksum``, ``local_norm``, ``gmg_*``), the ELL kernel's launches in the
two halo-plan solves, the true residual, the wall, build and solve
seconds (the eager GMG solve's too), each solve's mode and host reads,
the capture and instantiate seconds and warm-up launches of the stepped
solves, the ms of one replay of each ``ShardedGMG`` graph, the bytes that
halo imports and coarse gathers sent to the other ranks per V-cycle, the
seconds inside collectives (null for a kind that a graph replay ran: a
collective inside a replay cannot be timed on the host) and the peak
device memory.  :func:`launch` starts the workers of one run and
collects their lines; :func:`run_ranks` starts any set of ranks at a free
port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODULE = "coulomb_gmg_tpu_torch.parallel.multihost"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHARDS_PER_RANK = 2


def poisson_7pt(m: int):
    """7-point Laplacian on an m^3 grid as COO (deterministic, replicated
    on every process: the problem, not the distributed state)."""
    n = m ** 3
    idx = np.arange(n).reshape(m, m, m)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [6.0 * np.ones(n)]
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [-np.ones(len(a)), -np.ones(len(a))]
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


def problem(name: str, device):
    """The single-device ``Simulation`` whose last system ``ShardedGMG``
    solves, after its run."""
    from coulomb_gmg_tpu_torch.config import (golden_gaussian_config,
                                              production_scaling_config)
    from coulomb_gmg_tpu_torch.driver import Simulation
    from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice, two_atom_pair
    from coulomb_gmg_tpu_torch.utils.logging import Pcout
    if name == "small":
        cfg = golden_gaussian_config(n_adaptive_cycles=2,
                                     flag_output_time=False,
                                     mesh_size_h=0.5, vacuum_repetitions=4)
        atoms = two_atom_pair()
    else:
        cfg = production_scaling_config(10, dtype="float64",
                                        n_adaptive_cycles=3)
        atoms = nacl_lattice(10)
    sim = Simulation(cfg, atoms=atoms, device=device,
                     pcout=Pcout(enabled=False))
    sim.run()
    return sim


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def jacobi(ctx, halo: bool, fused: bool):
    """The sharded Jacobi-CG of tests/multihost_worker.py; returns (local
    blocks, iterations, |r0|, |r|, the solver's ``info``)."""
    from coulomb_gmg_tpu_torch.parallel.sharded import (
        ShardedCSR, make_sharded_solver, put_blocks, shard_vector,
        sharded_diag)
    rows, cols, vals, n = poisson_7pt(12)
    A = ShardedCSR.from_coo(rows, cols, vals, n, ctx.D)
    b = np.random.default_rng(7).standard_normal(n)
    solver = make_sharded_solver(ctx, A, sharded_diag(A, ctx.D),
                                 tol_rtol=1e-10, maxiter=2000, damping=0.6,
                                 halo=halo, fused=fused)
    rhs = put_blocks(shard_vector(b, ctx.D), ctx)
    return (*solver(rhs, [torch.zeros_like(v) for v in rhs]), solver.info)


def gmg(ctx, sim, halo: bool, fused: bool, sg=None, replay: bool = False):
    """``ShardedGMG`` on ``sim``'s last system, a new one or ``sg`` again,
    in the form ``fused``; returns (solver, local blocks, iterations,
    |r0|, |r|, coarse iterations per V-cycle, build seconds, solve
    seconds, and with ``replay`` the ms of one replay of each segment's
    graph when the solve captured them, else None)."""
    from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
    t0 = time.perf_counter()
    if sg is None:
        sg = ShardedGMG(sim.gmg, sim.A, ctx, dtype=sim.dtype, maxiter=50,
                        halo=halo, fused=fused)
    sg.fused = fused
    _sync(ctx.devices[0])
    t1 = time.perf_counter()
    n0 = len(sg.coarse_iterations)
    xb, k, res0, res = sg.solve_global(np.asarray(sim.rhs), rtol=1e-8)
    _sync(ctx.devices[0])
    t2 = time.perf_counter()
    ms = None
    if replay and sg.stepped is not None and sg.stepped.segments.graphs:
        ms = sg.stepped.segments.replay_ms(SEGMENTS)
    sg.release()
    return (sg, xb, k, res0, res, sg.coarse_iterations[n0:], t1 - t0,
            t2 - t1, ms)


# the stepped ShardedGMG's segments, in the order a step runs them
SEGMENTS = ("start_head", "start_tail", "step_head", "coarse", "step_tail")


def checksum(ctx, xb) -> float:
    """sum(x^2) over the whole solution, by ``psum``: the same bits on
    every rank."""
    return float(ctx.psum([torch.sum(x * x) for x in xb])[0])


def full(ctx, xb) -> torch.Tensor:
    """The whole solution on this rank, on the host."""
    return ctx.all_gather(xb)[0].cpu()


def true_residual(A, b, x) -> float:
    """||b - A x|| / ||b|| in float64 on the host."""
    x = np.asarray(x, np.float64)
    Ax = np.bincount(A.rowids, weights=A.data_np().astype(np.float64)
                     * x[A.indices], minlength=A.n_rows)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - Ax) / np.linalg.norm(b))


def run(rank: int, world: int, port: int, device: str, backend: str,
        problem_name: str, fused: bool = True) -> dict:
    import torch.distributed as dist
    from coulomb_gmg_tpu_torch.ops.ell import ell_mv
    from coulomb_gmg_tpu_torch.parallel.spmd import CommStats, SpmdContext
    from coulomb_gmg_tpu_torch.utils.platform import init_distributed

    t_start = time.perf_counter()
    dev = init_distributed(init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank, backend=backend,
                           device=device, local_rank=rank)
    D = SHARDS_PER_RANK * world
    ctx = SpmdContext(D, [dev] * SHARDS_PER_RANK, group=dist.group.WORLD)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": rank, "world": world, "backend": backend,
           "device": str(dev), "devices": D, "shards": ctx.shards,
           "problem": problem_name, "fused": fused}

    # ---- 1. sharded Jacobi-CG
    ell_mv.launches = 0
    xb, k, res0, res, info = jacobi(ctx, True, fused)
    launches = ell_mv.launches
    x_jac = full(ctx, xb)
    out.update(jacobi_mode=info["mode"], jacobi_reads=info["reads"],
               jacobi_capture_s=info.get("capture_s"),
               jacobi_instantiate_s=info.get("instantiate_s"),
               iters=int(k),
               rel_res=float(res) / float(res0),
               checksum=checksum(ctx, xb),
               local_norm=float(torch.linalg.norm(
                   torch.cat([x.cpu() for x in xb]))))
    xb_g = jacobi(ctx, False, fused)[0]
    jac_gather_equal = torch.equal(full(ctx, xb_g), x_jac)

    # ---- 2. ShardedGMG on the replicated problem's last system
    t0 = time.perf_counter()
    sim = problem(problem_name, dev)
    out["problem_s"] = time.perf_counter() - t0
    out["n_cells"] = int(sim.forest.n_cells)
    out["n_dofs"] = int(sim.A.n_rows)
    ell_mv.launches = 0
    ctx.stats = CommStats()
    sg, xg, kg, res0g, resg, coarse, t_build, t_solve, replay = gmg(
        ctx, sim, True, fused, replay=True)
    launches += ell_mv.launches
    stats, ctx.stats = ctx.stats, CommStats()
    info = sg.solve_info()
    vcycles = len(coarse)
    x_gmg = full(ctx, xg)
    out.update(
        gmg_iters=int(kg), gmg_rel_res=float(resg) / max(float(res0g),
                                                         1e-300),
        gmg_true_rel_res=true_residual(sim.A, sim.rhs,
                                       x_gmg.numpy()[: sim.A.n_rows]),
        gmg_checksum=checksum(ctx, xg),
        gmg_local_norm=float(torch.linalg.norm(
            torch.cat([x.cpu() for x in xg]))),
        gmg_mode=info["mode"], gmg_reads=info["reads"],
        gmg_capture_s=info.get("capture_s"),
        gmg_instantiate_s=info.get("instantiate_s"),
        gmg_warmup=info.get("warmup"), gmg_replay_ms=replay,
        gmg_levels=len(sg.levels), gmg_build_s=t_build, gmg_solve_s=t_solve,
        vcycles=vcycles, coarse_cg=list(coarse),
        halo_bytes_per_vcycle=stats.bytes.get("halo", 0) / max(vcycles, 1),
        coarse_bytes_per_vcycle=stats.bytes.get("coarse", 0)
        / max(vcycles, 1),
        comm_calls=dict(stats.calls), comm_bytes=dict(stats.bytes),
        comm_s=dict(stats.seconds), ell_launches=launches)
    if fused:
        # this rank's eager loops across the same processes: the bits,
        # counts and reads of the stepped solves
        xe, ke, r0e, re, ie = jacobi(ctx, True, False)
        ge = gmg(ctx, sim, True, False, sg=sg)
        ctx.stats = CommStats()
        out["gmg_eager_solve_s"] = ge[7]
        out["eager_equal"] = {
            "jacobi": bool((ke, r0e, re, ie["reads"])
                           == (k, res0, res, out["jacobi_reads"])
                           and torch.equal(full(ctx, xe), x_jac)),
            "gmg": bool(ge[2:6] == (kg, res0g, resg, coarse)
                        and sg.solve_info()["reads"] == info["reads"]
                        and torch.equal(full(ctx, ge[1]), x_gmg))}
    xg_g = gmg(ctx, sim, False, fused)[1]
    out["gather_equal"] = {"jacobi": jac_gather_equal,
                           "gmg": torch.equal(full(ctx, xg_g), x_gmg)}

    # ---- the one-process D-shard solves of the same systems (rank 0), in
    # this form and in the other
    if rank == 0:
        one = SpmdContext(D, [dev] * D)
        for key, form in (("one_process_equal", fused),
                          ("other_form_equal", not fused)):
            xb1, k1 = jacobi(one, True, form)[:2]
            g1 = gmg(one, sim, True, form)
            out[key] = {
                "jacobi": bool(k1 == k and torch.equal(full(one, xb1),
                                                       x_jac)),
                "gmg": bool(g1[2] == kg and torch.equal(full(one, g1[1]),
                                                        x_gmg))}
            if form == fused:
                out["one_process_gmg_solve_s"] = g1[7]
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    out["wall_s"] = time.perf_counter() - t_start
    dist.destroy_process_group()
    return out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_taken(stderr: str) -> bool:
    """Whether a rank failed because its rendezvous port was taken between
    :func:`free_port` and the bind."""
    return "EADDRINUSE" in stderr or "address already in use" in \
        stderr.lower()


def run_ranks(command, world: int, timeout_s: float) -> list:
    """Run the ``world`` processes ``command(rank, port) -> (argv, env)``
    from the repository root, joined at a free port, and return each
    one's ``(exit code, stdout, end of stderr)`` in rank order.  Once a
    process fails, or the run outlasts ``timeout_s``, every process still
    running is killed.  A run whose port another process took first is
    made once more on a new port."""
    outs = _run_ranks(command, world, timeout_s)
    if any(rc != 0 and port_taken(err) for rc, _, err in outs):
        outs = _run_ranks(command, world, timeout_s)
    return outs


def _run_ranks(command, world, timeout_s) -> list:
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        for r in range(world):
            argv, env = command(r, port)
            out = open(os.path.join(tmp, f"{r}.out"), "w+")
            err = open(os.path.join(tmp, f"{r}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(argv, cwd=ROOT, env=env,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            outs.append((p.returncode, out.read(), err.read()[-3000:]))
            out.close()
            err.close()
    return outs


def env_with_root(**extra) -> dict:
    """This environment with the repository root first on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update(extra)
    return env


def launch(devices: list, backend: str, problem_name: str,
           timeout_s: float, fused: bool = True) -> list:
    """Run one worker per entry of ``devices`` (rank r on ``devices[r]``),
    in the stepped form or the eager one (``fused``), and return their
    JSON lines in rank order.  If a worker fails, or the
    run outlasts ``timeout_s``, every worker still running is killed and
    RuntimeError carries each rank's exit code and the end of its
    stderr."""
    env = env_with_root()
    outs = run_ranks(lambda r, port: (
        [sys.executable, "-m", MODULE, str(r), str(len(devices)), str(port),
         "--device", devices[r], "--backend", backend, "--problem",
         problem_name, "--fused" if fused else "--no-fused"], env),
        len(devices), timeout_s)
    failed = [f"rank {r}: exit {rc}\n{err}"
              for r, (rc, _, err) in enumerate(outs) if rc != 0]
    if failed:
        raise RuntimeError("multihost workers failed (timeout "
                           f"{timeout_s} s):\n" + "\n".join(failed))
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    ap.add_argument("--problem", choices=["small", "8k"], default="small")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True, help="the stepped solves (default) or "
                    "the eager loops")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    out = run(args.rank, args.world, args.port, args.device, args.backend,
              args.problem, args.fused)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
