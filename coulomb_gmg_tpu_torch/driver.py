"""Simulation driver of the PyTorch port: the adaptive cycle.

Counterpart of coulomb_gmg_tpu/driver.py in its device-operator mode
(``Simulation.device_ops_active``): the configuration of the reference's
published scaling study (config.py:production_scaling_config), and the
GaussianCharges ``.prm`` settings around it (brute-force density, FE-error
postprocess, volume-residual Kelly term, Homogeneous / Inhomogeneous /
Exact boundary values).  Per adaptive cycle:

1. the charge density at the RHS quadrature points on the device: with
   the locality flag, atom buckets and the tile plan (host numpy) and the
   tile kernel (ops/tile_density.py); without it, every atom at every
   point (ops/density.py, kernel);
2. the float64 RHS, assembled on the device (solver/device_gmg.py);
3. GMG level, interface and transfer operators built on the device from
   compact topology (ops/stencil.py);
4. GMG-preconditioned CG in float32 (solver/gmg.py, ELL kernel) inside
   iterative refinement to a true float64 ``cg_rtol * ||b||``;
5. the float64 Kelly estimate (plain, or with the volume residual),
   0.6 * max marking (adapt/estimator.py);
6. below 300 atoms the electrostatic energy, and the FE error in the
   energy norm with the exact-gradient kernel (postprocess/energy.py);
7. refinement and solution transfer (mesh/forest.py, adapt/transfer.py).

Mesh, DoF and constraint topology stays on the host, in the package's
numpy modules (mesh/, fem/, adapt/transfer.py).  A configuration outside
this slice raises NotImplementedError; ROADMAP.md lists what is still to
port.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (
    build_face_plan, update_face_plan, estimate, mark_cells)
from coulomb_gmg_tpu_torch.adapt.transfer import (old_cell_of_new,
                                                  transfer_solution)
from coulomb_gmg_tpu_torch.config import Config
from coulomb_gmg_tpu_torch.device import resolve
from coulomb_gmg_tpu_torch.fem.constraints import (build_constraints,
                                                   distribute, set_zero)
from coulomb_gmg_tpu_torch.io.lammps import AtomData, read_lammps_file
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.utils.logging import Pcout, sci10, fix10
from coulomb_gmg_tpu_torch.utils.timer import TimerOutput
from coulomb_gmg_tpu_torch.models import problems as P
from coulomb_gmg_tpu_torch.ops.density import density_bruteforce
from coulomb_gmg_tpu_torch.ops.tile_density import density_locality_tiles
from coulomb_gmg_tpu_torch.postprocess.energy import (electrostatic_energy,
                                                      energy_norm_error)
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
        "device_operators='off' (host CSR assembly)":
            cfg.device_operators == "off",
        "flag_compute_quadrupole": cfg.flag_compute_quadrupole,
        "write_vtu (output)": cfg.write_vtu,
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            "coulomb_gmg_tpu_torch runs the device-operator cycle only; "
            f"not ported yet: {', '.join(bad)} (see ROADMAP.md, Queue 1)")


class Simulation:
    """One adaptive simulation on one device (the reference's
    LaplaceProblem, production configuration).

    ``device`` defaults to "cuda", the hand kernels on the card, and
    raises without one; "cpu" runs their plain PyTorch versions (tests)."""

    def __init__(self, cfg: Config, atoms: AtomData = None, device="cuda",
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
        self.tab_lap = element_tables(cfg.dim, 1, 2)
        self.dipole = np.zeros(cfg.dim)
        self.pcout(f"Problem type is:   {cfg.problem}")
        self.pcout(f"Preconditioner :    {cfg.preconditioner}")
        self.pcout("Rhs assembly optimization ENABLED" if cfg.flag_rhs_assembly
                   else "Without rhs assembly optimization")
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
        """Dirichlet values (coulomb_gmg_tpu/driver.py:154-170): zero
        (Homogeneous), the dipole far field (Inhomogeneous; the quadrupole
        is zero, as in the reference, src/step-50.cc:624) or the analytic
        solution (Exact), in float64."""
        cfg = self.cfg
        t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        if cfg.boundary_conditions == "Homogeneous":
            return None
        if cfg.boundary_conditions == "Inhomogeneous":
            return lambda pts: P.nonzero_dbc(
                t64(pts), np.zeros(cfg.dim), self.dipole,
                np.zeros((cfg.dim, cfg.dim))).numpy()
        pos, q = t64(self.atoms.positions), t64(self.atoms.charges)
        return lambda pts: P.analytic_solution(t64(pts), pos, q,
                                               cfg.r_c).numpy()

    # -------------------------------------------------------------- setup

    def setup(self):
        cfg = self.cfg
        f = self.forest
        with self._stage("Setup system"):
            dofs = f.dofs_of(1)
        with self._stage("Compute charge densities"):
            if cfg.flag_rhs_assembly:
                self.rho = density_locality_tiles(
                    f, self.tab_rhs.points, self.atoms.positions,
                    self.atoms.charges, cfg.r_c,
                    cfg.nonzero_radius * cfg.r_c, self.device,
                    c_pad=f.n_cells + 1)
            else:
                self.rho = density_bruteforce(
                    f, self.tab_rhs.points, self.atoms.positions,
                    self.atoms.charges, cfg.r_c, self.device,
                    c_pad=f.n_cells + 1)
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
            rho_q = (self.rho[: self.forest.n_cells].cpu().numpy()
                     if cfg.estimator_volume_term else None)
            err = estimate(self.forest, self.forest.dofs_of(1).cell2dof,
                           self.solution, rho_q, self.tab_rhs.points,
                           self.tab_rhs.weights, degree=1,
                           use_volume_term=cfg.estimator_volume_term,
                           plan=self._face_plan)
            self.error_per_cell = err
            self.flags, self.threshold = mark_cells(
                err, cfg.refine_fraction_of_max)
        self.pcout("Threshold value for refinement:\t"
                   + sci10(self.threshold))

    # -------------------------------------------------------- postprocess

    def postprocess_energy(self):
        with self._stage("Postprocess electrostatic energy"):
            e = electrostatic_energy(self.forest, self.solution,
                                     self.atoms.positions, self.atoms.charges,
                                     self.cfg.r_c)
        pc = self.pcout
        pc("\nTotal analytical electrostatic energy :   " + sci10(e["analytic"]))
        pc("Short-ranged energy contribution :  " + sci10(e["short_range"]))
        pc("FE solution long-ranged energy contribution :    "
           + sci10(e["fe_long_range"]))
        pc("Self energy contribution : " + sci10(e["self_energy"]))
        pc("Total electrostatic energy with split in short- and long-ranged : "
           + sci10(e["total_split"]))
        pc("Absolute Error between both energies :\t" + sci10(e["abs_error"])
           + "\n")
        pc("Relative Error in total electrostatic energy :\t"
           + sci10(e["rel_error"]))
        return e

    def postprocess_energy_norm(self):
        if not self.cfg.flag_postprocess_error:
            return None
        with self._stage("Postprocess FE error"):
            err = energy_norm_error(self.forest, self.tab_lap, self.solution,
                                    self.atoms.positions, self.atoms.charges,
                                    self.cfg.r_c, self.device)
        self.pcout("Error in FE solution in energy norm:  " + sci10(err))
        return err

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
            from coulomb_gmg_tpu_torch.utils.checkpoint import load_checkpoint
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
            cyc = {
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
            }
            if self.atoms.n < 300:
                cyc["energy"] = self.postprocess_energy()
            cyc["energy_norm_error"] = self.postprocess_energy_norm()
            cyc["stages"] = dict(self._stages)
            self.results.append(cyc)
            if cfg.checkpoint_dir:
                from coulomb_gmg_tpu_torch.utils.checkpoint import save_checkpoint
                save_checkpoint(os.path.join(
                    cfg.checkpoint_dir, f"ckpt_cycle{cycle:03d}.npz"),
                    self, cycle)

        if cfg.flag_output_time:
            self.timer.summary(pc)
            pc(f"   \nTotal Elapsed wall time for solution: "
               f"{self.timer.total_wall()} seconds.\n")
        return self.results
