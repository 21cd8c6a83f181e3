"""Preconditioned conjugate gradients with deal.II ``SolverCG`` semantics.

Counterpart of coulomb_gmg_tpu/solver/cg.py (used at
src/step-50.cc:938-1017):

* the "starting value" is the l2 norm of the initial residual b - A x0;
* the tolerance is absolute (the reference passes ``1e-8 * ||b||``, resp.
  ``1e-10``);
* convergence is tested on the recurrence residual right after the x / r
  update, so "converged in N iterations" counts full CG steps;
* a residual already under the tolerance gives 0 iterations.

The JAX module has a traced ``lax.while_loop`` and a host loop with the
same math.  Here the loop runs on the host and reads one scalar, the
residual norm, per iteration (:func:`to_host`); the vectors stay on their
device.  The preconditioner is any callable (Jacobi, the host SSOR sweep,
a V-cycle).  solver/fused.py steps the same arithmetic on the device:
``stepped_cg`` is this function as JAX's ``host=False`` loop, the
driver's route for the Jacobi preconditioner under ``solve_fused``; the
host SSOR of the GMG route stays in this host loop, as JAX runs it with
``host=True``.
"""

from __future__ import annotations

from time import perf_counter_ns
from typing import Callable, NamedTuple, Optional

import torch

from coulomb_gmg_tpu_torch.utils.timer import count, tracing


def _counted(read, t):
    """``read(t)``, a blocking read from the device, counted in the open
    run's ``host_reads`` and ``host_read_ns`` (the wait included)."""
    if not tracing():
        return read(t)
    t0 = perf_counter_ns()
    out = read(t)
    count("host_reads")
    count("host_read_ns", perf_counter_ns() - t0)
    return out


def to_host(t: torch.Tensor):
    """``t.tolist()``: the value of a small device tensor on the host, one
    read from the device, counted in ``to_host.reads`` (the solver loops'
    reads; a CPU tensor counts as well, standing for the card's) and in the
    run's ``host_reads``."""
    to_host.reads += 1
    return _counted(torch.Tensor.tolist, t)


to_host.reads = 0


def host_float(t: torch.Tensor) -> float:
    """``float(t)``, counted as :func:`to_host` counts in the run, not in
    ``to_host.reads``: the reads around the solver loops."""
    return _counted(float, t)


def host_array(t: torch.Tensor):
    """``t.cpu().numpy()``, counted as :func:`host_float`."""
    return _counted(_numpy, t)


def _numpy(t):
    return t.cpu().numpy()


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    initial_residual: float        # ||b - A x0||
    final_residual: float


def cg(apply_A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, precond: Optional[Callable] = None, tol: float,
       maxiter: int) -> CGResult:
    """Solve A x = b to ``||r||_2 < tol`` (absolute) or ``maxiter``."""
    M = precond if precond is not None else (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    res0 = to_host(torch.linalg.vector_norm(r))
    res = res0
    k = 0
    if res >= tol:
        z = M(r)
        rho = torch.dot(r, z)
        p = z
        while True:
            q = apply_A(p)
            alpha = rho / torch.dot(p, q)
            x = x + alpha * p
            r = r - alpha * q
            res = to_host(torch.linalg.vector_norm(r))
            k += 1
            if res < tol or k >= maxiter:
                break
            z = M(r)
            rho_new = torch.dot(r, z)
            p = z + (rho_new / rho) * p
            rho = rho_new
    return CGResult(x=x, iterations=k, initial_residual=res0,
                    final_residual=res)
