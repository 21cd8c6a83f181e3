"""Simulation driver of the PyTorch port: the production adaptive cycle.

Counterpart of coulomb_gmg_tpu/driver.py in its device-operator mode
(``Simulation.device_ops_active``), the configuration of the reference's
published scaling study (config.py:production_scaling_config).  Per
adaptive cycle:

1. atom buckets and the tile plan (host numpy), then the charge density at
   the RHS quadrature points on the device (ops/tile_density.py, kernel);
2. the float64 RHS, assembled on the device (solver/device_gmg.py);
3. GMG level, interface and transfer operators built on the device from
   compact topology (ops/stencil.py);
4. GMG-preconditioned CG in float32 (solver/gmg.py, ELL kernel) inside
   iterative refinement to a true float64 ``cg_rtol * ||b||``;
5. the float64 Kelly estimate, 0.6 * max marking, refinement and solution
   transfer (adapt/estimator.py, mesh/forest.py, adapt/transfer.py).

Mesh, DoF and constraint topology stays on the host, in the
framework-neutral modules of coulomb_gmg_tpu.  A configuration outside this
slice raises NotImplementedError; ROADMAP.md lists what is still to port.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from coulomb_gmg_tpu.adapt.transfer import old_cell_of_new, transfer_solution
from coulomb_gmg_tpu.config import Config
from coulomb_gmg_tpu.fem.constraints import (build_constraints, distribute,
                                             set_zero)
from coulomb_gmg_tpu.io.lammps import AtomData, read_lammps_file
from coulomb_gmg_tpu.mesh.forest import Forest
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.utils.logging import Pcout, sci10, fix10
from coulomb_gmg_tpu.utils.timer import TimerOutput
from coulomb_gmg_tpu_torch.adapt.estimator import (
    build_face_plan, update_face_plan, estimate, mark_cells)
from coulomb_gmg_tpu_torch.device import resolve
from coulomb_gmg_tpu_torch.models import problems as P
from coulomb_gmg_tpu_torch.ops.tile_density import density_locality_tiles
from coulomb_gmg_tpu_torch.solver.device_gmg import (StencilGMG,
                                                     solve_refined_device)


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration the port cannot run."""
    unsupported = {
        "problem != 'GaussianCharges' (Step16)":
            cfg.problem != "GaussianCharges",
        "dim != 3": cfg.dim != 3,
        "degree > 1": cfg.degree != 1,
        "preconditioner != 'GMG'": cfg.preconditioner != "GMG",
        "dtype != 'float32' (the float64 golden host path)":
            cfg.dtype != "float32",
        "n_devices > 1": cfg.n_devices != 1,
        "flag_postprocess_error (FE-error postprocess)":
            cfg.flag_postprocess_error,
        "flag_rhs_assembly off (brute-force density)":
            not cfg.flag_rhs_assembly,
        "device_operators='off' (host CSR assembly)":
            cfg.device_operators == "off",
        "boundary_conditions != 'Inhomogeneous'":
            cfg.boundary_conditions != "Inhomogeneous",
        "estimator_volume_term (volume-residual Kelly)":
            cfg.estimator_volume_term,
        "flag_compute_quadrupole": cfg.flag_compute_quadrupole,
        "write_vtu (output)": cfg.write_vtu,
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            "coulomb_gmg_tpu_torch runs the production adaptive cycle only; "
            f"not ported yet: {', '.join(bad)} (see ROADMAP.md, Queue 1)")


class Simulation:
    """One adaptive simulation on one device (the reference's
    LaplaceProblem, production configuration).

    ``device`` is required: "cuda" runs the hand kernels on the card,
    "cpu" runs their plain PyTorch versions (tests)."""

    def __init__(self, cfg: Config, atoms: AtomData = None, device=None,
                 pcout=None):
        check_slice(cfg)
        self.device = resolve(device)
        self.cfg = cfg
        self.pcout = pcout or Pcout()
        self.timer = TimerOutput()
        self.results = []
        self.dtype = torch.float32
        if atoms is None:
            atoms = read_lammps_file(cfg.lammps_file, cfg.dim)
        if not atoms.has_atoms:
            raise NotImplementedError(
                "the analytic-RHS path (no atoms) is not ported yet "
                "(see ROADMAP.md, Queue 1)")
        self.atoms = atoms
        self.forest: Forest = None
        self.solution = None
        self.flags = None
        self.mask = None             # checkpoint fields of the JAX driver;
        self.lists = None            # the tile density needs neither
        self.error_per_cell = None
        self._face_plan = None
        self._stencil_cache = {}
        self._stages = {}
        self.tab_rhs = element_tables(cfg.dim, 1, 1 + cfg.quadrature_degree_rhs)
        self.dipole = np.zeros(cfg.dim)
        self.pcout(f"Problem type is:   {cfg.problem}")
        self.pcout(f"Preconditioner :    {cfg.preconditioner}")
        self.pcout(f"Number of atoms: {self.atoms.n}")

    @contextmanager
    def _stage(self, name: str):
        """Timed pipeline stage; device work is synchronized at its end so
        the seconds are the stage's own."""
        t0 = time.time()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        self.timer.totals[name] += dt
        self.timer.calls[name] += 1
        self._stages[name] = self._stages.get(name, 0.0) + dt

    # ------------------------------------------------------------ meshing

    def make_initial_mesh(self) -> Forest:
        """Subdivided rectangle with vacuum margin
        (src/step-50.cc:1504-1526)."""
        cfg = self.cfg
        a = 2.0 * cfg.mesh_size_h
        N = (cfg.domain_right - cfg.domain_left) / a
        M = cfg.vacuum_repetitions
        reps = int(round(2 * (N + 2 * M)))
        lower = np.full(cfg.dim, cfg.domain_left - M * a)
        return Forest.uniform(cfg.dim, reps, lower, cfg.mesh_size_h)

    def boundary_fn(self):
        """Dipole far-field Dirichlet values (the quadrupole is zero, as
        in the reference, src/step-50.cc:624)."""
        dim = self.cfg.dim
        return lambda pts: P.nonzero_dbc(
            torch.from_numpy(np.asarray(pts, np.float64)), np.zeros(dim),
            self.dipole, np.zeros((dim, dim))).numpy()

    # -------------------------------------------------------------- setup

    def setup(self):
        cfg = self.cfg
        f = self.forest
        with self._stage("Setup system"):
            dofs = f.dofs_of(1)
        with self._stage("Compute charge densities"):
            self.rho = density_locality_tiles(
                f, self.tab_rhs.points, self.atoms.positions,
                self.atoms.charges, cfg.r_c, cfg.nonzero_radius * cfg.r_c,
                self.device, c_pad=f.n_cells + 1)
        with self._stage("Compute dipole moments"):
            self.dipole = P.compute_dipole_moment(self.atoms.positions,
                                                  self.atoms.charges)
        with self._stage("Setup system"):
            self.constraints = build_constraints(dofs, self.boundary_fn())

    # ----------------------------------------------------------- assembly

    def assemble_system(self):
        f = self.forest
        with self._stage("Assemble Multigrid"):
            self.gmg = StencilGMG(f, f.dofs_of(1), self.constraints,
                                  self.device, self.dtype,
                                  cache=self._stencil_cache)
        with self._stage("Assemble system"):
            self.rhs = self.gmg.assemble_rhs(self.rho, self.tab_rhs)

    # -------------------------------------------------------------- solve

    def solve(self):
        cfg = self.cfg
        pc = self.pcout
        g = self.gmg
        with self._stage("Solve"):
            b = self.rhs[: g.n].cpu().numpy()
            x0 = (self.solution if self.solution is not None
                  and len(self.solution) == g.n else None)
            x, k, res0, resf, passes = solve_refined_device(
                g, x0, rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters)
            self.solution = distribute(self.constraints, x)
        self.cg_iterations = int(k)
        self.cg_passes = passes
        self.cg_start = float(res0)
        self.residual = float(resf)
        self.norms = {
            "l1_rhs": float(np.abs(b).sum()),
            "l2_rhs": float(np.linalg.norm(b)),
            "linf_rhs": float(np.abs(b).max()),
            "l1_sol": float(np.abs(x).sum()),
            "l2_sol": float(np.linalg.norm(x)),
            "linf_sol": float(np.abs(x).max()),
        }
        pc("   L1 rhs norm " + sci10(self.norms["l1_rhs"]))
        pc("   L2 rhs norm " + sci10(self.norms["l2_rhs"]))
        pc("   LInfinity rhs norm " + sci10(self.norms["linf_rhs"]))
        pc("   Starting value " + fix10(res0))
        pc(f"   CG converged in {k} iterations.")
        pc("   Convergence value " + sci10(resf))
        pc("   L1 solution norm " + sci10(self.norms["l1_sol"]))
        pc("   L2 solution norm " + sci10(self.norms["l2_sol"]))
        pc("   LInfinity solution norm " + sci10(self.norms["linf_sol"]))

    # --------------------------------------------------------- adaptivity

    def estimate_and_mark(self):
        cfg = self.cfg
        with self._stage("Estimate error and mark cells"):
            if self._face_plan is None:
                self._face_plan = build_face_plan(self.forest)
            err = estimate(self.forest, self.forest.dofs_of(1).cell2dof,
                           self.solution, None, self.tab_rhs.points,
                           self.tab_rhs.weights, degree=1,
                           use_volume_term=False, plan=self._face_plan)
            self.error_per_cell = err
            self.flags, self.threshold = mark_cells(
                err, cfg.refine_fraction_of_max)
        self.pcout("Threshold value for refinement:\t"
                   + sci10(self.threshold))

    def refine(self):
        with self._stage("Refine, solution transfer and sending atoms "
                         "list to child cells"):
            old = self.forest
            new = old.refine(self.flags)
            omap = old_cell_of_new(old, new)
            u_new = transfer_solution(old, new, self.solution, degree=1,
                                      omap=omap)
            if self._face_plan is not None:
                self._face_plan = update_face_plan(old, new, self._face_plan,
                                                   omap)
            self.forest = new
            self.solution = u_new
        self.setup()
        self.solution = set_zero(self.constraints, self.solution)

    # ---------------------------------------------------------------- run

    def run(self):
        cfg = self.cfg
        pc = self.pcout
        pc(f"Running with PyTorch on {self.device}")
        pc(f"Dimension:\t{cfg.dim}")
        start_cycle = 0
        if cfg.resume_from:
            from coulomb_gmg_tpu.utils.checkpoint import load_checkpoint
            (self.forest, self.solution, self.flags, _, _,
             done) = load_checkpoint(cfg.resume_from)
            start_cycle = done + 1
            pc(f"Resuming after cycle {done} from {cfg.resume_from}")

        for cycle in range(start_cycle, cfg.n_adaptive_cycles):
            self._stages = {}
            pc(f"Cycle {cycle}:")
            if cycle == 0:
                self.forest = self.make_initial_mesh()
                pc(f"   Number of active cells:       {self.forest.n_cells}")
                self.setup()
            else:
                self.refine()
                pc(f"   Number of active cells:       {self.forest.n_cells}")
            dofs = self.forest.dofs_of(1)
            by_level = ", ".join(str(ld.n_dofs) for ld in dofs.levels)
            pc(f"   Number of degrees of freedom: {dofs.n_dofs} "
               f"(by level: {by_level})")
            self.assemble_system()
            self.solve()
            self.estimate_and_mark()
            self.results.append({
                "cycle": cycle,
                "n_cells": self.forest.n_cells,
                "n_dofs": dofs.n_dofs,
                "dofs_by_level": [ld.n_dofs for ld in dofs.levels],
                "cg_iterations": self.cg_iterations,
                "cg_passes": self.cg_passes,
                "cg_start": self.cg_start,
                "residual": self.residual,
                "threshold": self.threshold,
                **self.norms,
                "stages": dict(self._stages),
            })
            if cfg.checkpoint_dir:
                from coulomb_gmg_tpu.utils.checkpoint import save_checkpoint
                save_checkpoint(os.path.join(
                    cfg.checkpoint_dir, f"ckpt_cycle{cycle:03d}.npz"),
                    self, cycle)

        if cfg.flag_output_time:
            self.timer.summary(pc)
            pc(f"   \nTotal Elapsed wall time for solution: "
               f"{self.timer.total_wall()} seconds.\n")
        return self.results
