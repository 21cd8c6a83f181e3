"""Simulation driver of the PyTorch port: the adaptive cycle.

Counterpart of coulomb_gmg_tpu/driver.py on one device.  Per adaptive
cycle: mesh (generate, or refine and transfer), setup (constraints,
locality, densities, moments), assembly, GMG or Jacobi CG solve, Kelly
estimate and marking, and the energy postprocess, with the reference's log
lines (src/step-50.cc:104-178, 1464-1573).  Two operator paths, chosen as
the JAX driver chooses them:

* **device operators** (``Simulation.device_ops``: float32,
  GaussianCharges with atoms, 3D, Q1, GMG, ``device_operators != "off"``;
  the production configuration, config.py:production_scaling_config): the
  density by the tile kernel (ops/tile_density.py) or, without the
  locality flag, the dense kernel (ops/density.py); the float64 RHS and GMG
  operators built on the device (solver/device_gmg.py); float32 GMG-CG
  with a matrix-free system matvec inside iterative refinement to a true
  float64 ``cg_rtol * ||b||`` (solver/gmg.py);
* **host-assembled** (everything else: float64, Step16, ``degree > 1``,
  ``device_operators="off"``, the analytic RHS, Jacobi, dim 2): the CSR
  system and the level matrices assembled on the host (fem/assembly.py,
  solver/multigrid.py) and applied on the device through the ELL kernel
  (ops/spmv.py), solved by one of three routes (:meth:`Simulation.solve`):
  ``TpuGMG`` with ``solve_refined`` or ``tpu_cg_solve`` (``use_tpu_cg``:
  ``solver_backend="tpu_cg"``, or ``"auto"`` in float32), else the host-loop
  ``cg`` with ``GMGPreconditioner`` (the reference's SSOR smoother by
  default) or Jacobi.  Float64 densities come from the mask and list
  branches of ops/density.py:compute_density, float32 ones from the
  kernels.

Mesh, DoF and constraint topology stays on the host, in the package's
numpy modules (mesh/, fem/, adapt/transfer.py).  Output (``write_vtu``) and
several devices raise NotImplementedError; ROADMAP.md lists them.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (
    build_face_plan, update_face_plan, estimate, mark_cells)
from coulomb_gmg_tpu_torch.adapt.transfer import (
    old_cell_of_new, transfer_cell_mask, transfer_solution)
from coulomb_gmg_tpu_torch.config import Config
from coulomb_gmg_tpu_torch.device import resolve
from coulomb_gmg_tpu_torch.fem.assembly import assemble_np, build_plan
from coulomb_gmg_tpu_torch.fem.constraints import (build_constraints,
                                                   distribute, set_zero)
from coulomb_gmg_tpu_torch.fem.integrals import (rhs_cells_np,
                                                 stiffness_cells_np)
from coulomb_gmg_tpu_torch.io.lammps import AtomData, read_lammps_file
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.utils.logging import Pcout, sci10, fix10
from coulomb_gmg_tpu_torch.utils.timer import TimerOutput
from coulomb_gmg_tpu_torch.models import problems as P
from coulomb_gmg_tpu_torch.ops.density import (
    atom_masks, cell_quad_points, compute_density, density_bruteforce)
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.neighbors import atom_lists
from coulomb_gmg_tpu_torch.ops.smoothers import make_jacobi
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.ops.tile_density import density_locality_tiles
from coulomb_gmg_tpu_torch.postprocess.energy import (electrostatic_energy,
                                                      energy_norm_error)
from coulomb_gmg_tpu_torch.solver.cg import cg
from coulomb_gmg_tpu_torch.solver.device_gmg import (StencilGMG,
                                                     solve_refined_device)
from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
from coulomb_gmg_tpu_torch.solver.tpu_cg import tpu_cg_solve
from coulomb_gmg_tpu_torch.solver.tpu_gmg import TpuGMG, solve_refined


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration the port cannot run."""
    unsupported = {
        "n_devices > 1": cfg.n_devices != 1,
        "write_vtu (output)": cfg.write_vtu,
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            "coulomb_gmg_tpu_torch runs one device without output; "
            f"not ported yet: {', '.join(bad)} (see ROADMAP.md, Queue 1)")


class Simulation:
    """One adaptive simulation on one device (the reference's
    LaplaceProblem).

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
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        self.pcout(f"Problem type is:   {cfg.problem}")
        self.pcout(f"Preconditioner :    {cfg.preconditioner}")
        self.pcout("Rhs assembly optimization ENABLED" if cfg.flag_rhs_assembly
                   else "Without rhs assembly optimization")
        if atoms is None:
            atoms = read_lammps_file(cfg.lammps_file, cfg.dim)
            if cfg.dim != 3:
                self.pcout("\nReading of Lammps input file implemented for "
                           "3D only\n")
            elif not atoms.has_atoms:
                self.pcout("Unable to open the file.")
        self.atoms = atoms
        self.lammpsinput = atoms.has_atoms
        if self.lammpsinput:
            self.pcout(f"Number of atoms: {self.atoms.n}")
        self.device_ops = (cfg.device_operators != "off"
                           and self.dtype == torch.float32
                           and cfg.problem == "GaussianCharges"
                           and cfg.degree == 1 and cfg.dim == 3
                           and cfg.preconditioner == "GMG"
                           and self.lammpsinput)
        self.use_tpu_cg = (cfg.solver_backend == "tpu_cg" or
                           (cfg.solver_backend == "auto"
                            and self.dtype == torch.float32))
        self.forest: Forest = None
        self.solution = None
        self.flags = None
        self.mask = None             # (cells, atoms) locality (float64, <= 64)
        self.lists = None            # (cells, K) atom lists (float64, > 64)
        self.error_per_cell = None
        self.gmg = None              # StencilGMG or GMGPreconditioner
        self._face_plan = None
        self._stencil_cache = {}
        self._gmg_cache = {}
        self._tpu_host_cache = {}
        self._stages = {}
        self.tab_rhs = element_tables(cfg.dim, cfg.degree,
                                      cfg.degree + cfg.quadrature_degree_rhs)
        self.tab_lap = element_tables(cfg.dim, cfg.degree, cfg.degree + 1)
        self.dipole = np.zeros(cfg.dim)
        self.quadrupole = np.zeros((cfg.dim, cfg.dim))

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
        cfg = self.cfg
        if cfg.problem == "Step16":
            # hyper_cube + refine_global (src/step-50.cc:1496-1497)
            return Forest.hyper_cube(cfg.dim, cfg.domain_left,
                                     cfg.domain_right,
                                     cfg.n_global_refinements)
        # subdivided rectangle with vacuum margin (src/step-50.cc:1504-1526)
        a = 2.0 * cfg.mesh_size_h
        N = (cfg.domain_right - cfg.domain_left) / a
        M = cfg.vacuum_repetitions
        reps = int(round(2 * (N + 2 * M)))
        lower = np.full(cfg.dim, cfg.domain_left - M * a)
        return Forest.uniform(cfg.dim, reps, lower, cfg.mesh_size_h)

    def coeff_fn(self):
        """The Step16 coefficient; None (unit) for GaussianCharges."""
        return P.step16_coefficient if self.cfg.problem == "Step16" else None

    def boundary_fn(self):
        """Dirichlet values in float64: zero (Homogeneous), the multipole
        far field (Inhomogeneous: the dipole, and the quadrupole when
        ``flag_compute_quadrupole`` is set; the reference zeroes it,
        src/step-50.cc:624) or the analytic solution (Exact)."""
        cfg = self.cfg
        t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        if cfg.boundary_conditions == "Homogeneous":
            return None
        if cfg.boundary_conditions == "Inhomogeneous":
            return lambda pts: P.nonzero_dbc(
                t64(pts), np.zeros(cfg.dim), self.dipole,
                self.quadrupole).numpy()
        if cfg.problem != "GaussianCharges":
            raise ValueError("Exact BC requires GaussianCharges")
        pos, q = t64(self.atoms.positions), t64(self.atoms.charges)
        return lambda pts: P.analytic_solution(t64(pts), pos, q,
                                               cfg.r_c).numpy()

    def rho_host(self) -> np.ndarray:
        """The (n_cells, n_q) density as numpy."""
        return self.rho[: self.forest.n_cells].cpu().numpy()

    # -------------------------------------------------------------- setup

    def _density(self):
        """(n_cells + 1, n_q) density on the device (last row zero)."""
        cfg, f, at = self.cfg, self.forest, self.atoms
        c_pad = f.n_cells + 1
        if self.dtype == torch.float32:
            if cfg.flag_rhs_assembly:
                return density_locality_tiles(
                    f, self.tab_rhs.points, at.positions, at.charges,
                    cfg.r_c, cfg.nonzero_radius * cfg.r_c, self.device,
                    c_pad=c_pad)
            return density_bruteforce(f, self.tab_rhs.points, at.positions,
                                      at.charges, cfg.r_c, self.device,
                                      c_pad=c_pad)
        rho = compute_density(
            f, self.tab_rhs.points, at.positions, at.charges, cfg.r_c,
            self.device,
            mask=self.mask if cfg.flag_rhs_assembly else None,
            lists=self.lists if cfg.flag_rhs_assembly else None)
        return torch.cat([rho, rho.new_zeros(1, rho.shape[1])])

    def setup(self):
        cfg = self.cfg
        f = self.forest
        with self._stage("Setup system"):
            dofs = f.dofs_of(cfg.degree)
        if self.lammpsinput:
            # float64 densities use the locality of the JAX host path:
            # a dense mask up to 64 atoms, padded lists above
            if (self.dtype == torch.float64 and cfg.flag_rhs_assembly
                    and self.mask is None and self.lists is None):
                with self._stage("RHS assembly optimization"):
                    cut = cfg.nonzero_radius * cfg.r_c
                    if self.atoms.n > 64:
                        self.lists, _ = atom_lists(f, self.atoms.positions,
                                                   cut)
                    else:
                        self.mask = atom_masks(f, self.atoms.positions, cut,
                                               self.device)
            with self._stage("Compute charge densities"):
                self.rho = self._density()
            with self._stage("Compute dipole moments"):
                self.dipole = P.compute_dipole_moment(self.atoms.positions,
                                                      self.atoms.charges)
                if cfg.flag_compute_quadrupole:
                    self.quadrupole = P.quadrupole_from_forest(
                        f, self.tab_rhs.points, self.tab_rhs.weights,
                        self.rho_host())
        else:
            # analytic RHS (lammpsinput == 0), float64 on the host
            pts = torch.from_numpy(cell_quad_points(f, self.tab_rhs.points))
            rho = (P.step16_rhs(pts) if cfg.problem == "Step16"
                   else P.gaussian_rhs(pts, cfg.r_c))
            self.rho = torch.cat([rho, rho.new_zeros(1, rho.shape[1])])
        with self._stage("Setup system"):
            self.constraints = build_constraints(dofs, self.boundary_fn())
            self.plan = (None if self.device_ops
                         else build_plan(dofs.cell2dof, self.constraints))

    # ----------------------------------------------------------- assembly

    def assemble_system(self):
        cfg = self.cfg
        f = self.forest
        if self.device_ops:
            with self._stage("Assemble Multigrid"):
                self.gmg = StencilGMG(f, f.dofs_of(1), self.constraints,
                                      self.device, self.dtype,
                                      cache=self._stencil_cache)
            with self._stage("Assemble system"):
                self.rhs = self.gmg.assemble_rhs(self.rho.to(self.device),
                                                 self.tab_rhs)
            return
        with self._stage("Assemble system"):
            np_dtype = np.float32 if self.dtype == torch.float32 \
                else np.float64
            h = f.cell_h()
            coeff_q = None
            if self.coeff_fn() is not None:
                pts = cell_quad_points(f, self.tab_lap.points)
                coeff_q = self.coeff_fn()(torch.from_numpy(pts)).numpy()
            K = stiffness_cells_np(self.tab_lap, h, coeff_q, dtype=np_dtype)
            Fv = rhs_cells_np(self.tab_rhs, h, self.rho_host(),
                              dtype=np_dtype)
            data, rhs = assemble_np(self.plan, K, Fv, dtype=np_dtype)
            self.A = CSR.from_pattern(self.plan.pattern.indptr,
                                      self.plan.pattern.indices, data,
                                      device=self.device)
            self.rhs = rhs

    def assemble_multigrid(self):
        cfg = self.cfg
        if self.device_ops:
            return                  # StencilGMG was built with the system
        with self._stage("Assemble Multigrid"):
            # TpuGMG builds its own (Chebyshev) smoothers from the levels
            self.gmg = build_gmg(
                self.forest, self.forest.dofs_of(cfg.degree), self.tab_lap,
                coeff_fn=self.coeff_fn(),
                smoother="none" if self.use_tpu_cg else cfg.smoother,
                smoother_damping=cfg.smoother_damping,
                smoother_steps=cfg.smoother_steps,
                coarse_tol=cfg.coarse_tol,
                coarse_maxiter=cfg.coarse_max_iters, dtype=self.dtype,
                jacobi_damping=cfg.jacobi_damping,
                coarse_rtol=cfg.coarse_rtol, cache=self._gmg_cache,
                device=self.device)

    # -------------------------------------------------------------- solve

    def _log_solve(self, b, x, k, res0, resf, mat=None):
        pc = self.pcout
        self.norms = {
            "l1_rhs": float(np.abs(b).sum()),
            "l2_rhs": float(np.linalg.norm(b)),
            "linf_rhs": float(np.abs(b).max()),
            "l1_mat": None, "linf_mat": None, "fro_mat": None,
            "l1_sol": float(np.abs(x).sum()),
            "l2_sol": float(np.linalg.norm(x)),
            "linf_sol": float(np.abs(x).max()),
        }
        pc("   L1 rhs norm " + sci10(self.norms["l1_rhs"]))
        pc("   L2 rhs norm " + sci10(self.norms["l2_rhs"]))
        pc("   LInfinity rhs norm " + sci10(self.norms["linf_rhs"]))
        if mat is not None:
            self.norms.update(mat)
            pc("   L1 Matrix norm " + sci10(mat["l1_mat"]))
            pc("   LInfinity Matrix norm " + sci10(mat["linf_mat"]))
            pc("   Frobenius Matrix norm " + sci10(mat["fro_mat"]))
        pc("   Starting value " + fix10(res0))
        pc(f"   CG converged in {k} iterations.")
        pc("   Convergence value " + sci10(resf))
        pc("   L1 solution norm " + sci10(self.norms["l1_sol"]))
        pc("   L2 solution norm " + sci10(self.norms["l2_sol"]))
        pc("   LInfinity solution norm " + sci10(self.norms["linf_sol"]))
        self.solution = distribute(self.constraints, x)
        self.cg_iterations = int(k)
        self.cg_start = float(res0)

    def solve(self):
        with self._stage("Solve"):
            if self.device_ops:
                g = self.gmg
                b = self.rhs[: g.n].cpu().numpy()
                x0 = (self.solution if self.solution is not None
                      and len(self.solution) == g.n else None)
                x, k, res0, resf, self.cg_passes = solve_refined_device(
                    g, x0, rtol=self.cfg.cg_rtol,
                    maxiter=self.cfg.cg_max_iters)
                self.residual = float(resf)
                self._log_solve(b, x, k, res0, resf)
                return
            x, k, res0, resf = self._solve_assembled()
            self.cg_passes = None
            # the true residual of the returned solution, float64
            A64 = self.A.ell(dtype=torch.float64)
            xd = torch.from_numpy(x).to(self.device)
            bd = torch.from_numpy(np.asarray(self.rhs, np.float64)).to(
                self.device)
            self.residual = float(torch.linalg.vector_norm(
                bd - ell_mv(*A64, xd)))
            absd = np.abs(self.A.data_np()).astype(np.float64)
            colsum = np.bincount(self.A.indices, weights=absd,
                                 minlength=self.A.n_cols)
            mat = {"l1_mat": float(colsum.max()),
                   "linf_mat": float(np.add.reduceat(
                       absd, self.A.indptr[:-1]).max()),
                   "fro_mat": float(np.sqrt((absd ** 2).sum()))}
            self._log_solve(np.asarray(self.rhs), x, k, res0, resf, mat)

    def _solve_assembled(self):
        """The three routes of the host-assembled system (the JAX driver's
        solve, src/step-50.cc:938-1017).  Returns (x float64 numpy,
        iterations, |r0|, |r|)."""
        cfg = self.cfg
        rhs = np.asarray(self.rhs)
        x0 = (self.solution if self.solution is not None
              and len(self.solution) == self.A.n_rows else None)
        if self.use_tpu_cg and cfg.preconditioner == "GMG":
            g = TpuGMG(self.gmg, self.A, self.forest, self.device,
                       dtype=self.dtype,
                       use_dst=(cfg.problem == "GaussianCharges"
                                and cfg.degree == 1),
                       host_cache=self._tpu_host_cache)
            if self.dtype == torch.float32 and cfg.cg_rtol < 5e-7:
                # a float32 CG recurrence saturates near 6e-7 relative:
                # iterative refinement with a float64 defect
                return solve_refined(g, self.A, rhs, x0, rtol=cfg.cg_rtol,
                                     maxiter=cfg.cg_max_iters)
            x, k, res0, resf = g.solve(rhs, x0, rtol=cfg.cg_rtol,
                                       maxiter=cfg.cg_max_iters)
            return x.cpu().numpy().astype(np.float64), k, res0, resf
        if self.use_tpu_cg:
            x, k, res0, resf = tpu_cg_solve(
                self.A.rowids, self.A.indices, self.A.data_np(), rhs, x0,
                rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters * 10,
                device=self.device, dtype=self.dtype)
            return x.astype(np.float64), k, res0, resf
        put = lambda a: torch.from_numpy(np.asarray(a)).to(self.device,
                                                           self.dtype)
        precond = (self.gmg if cfg.preconditioner == "GMG"
                   else make_jacobi(self.A, cfg.jacobi_damping))
        res = cg(self.A.matvec, put(rhs),
                 x0=put(x0) if x0 is not None else None, precond=precond,
                 tol=cfg.cg_rtol * float(np.linalg.norm(rhs)),
                 maxiter=cfg.cg_max_iters)
        return (res.x.cpu().numpy().astype(np.float64), res.iterations,
                res.initial_residual, res.final_residual)

    # --------------------------------------------------------- adaptivity

    def estimate_and_mark(self):
        cfg = self.cfg
        with self._stage("Estimate error and mark cells"):
            if self._face_plan is None:
                self._face_plan = build_face_plan(self.forest)
            rho_q = self.rho_host() if cfg.estimator_volume_term else None
            err = estimate(self.forest,
                           self.forest.dofs_of(cfg.degree).cell2dof,
                           np.asarray(self.solution), rho_q,
                           self.tab_rhs.points, self.tab_rhs.weights,
                           degree=cfg.degree,
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
                                     self.cfg.r_c, degree=self.cfg.degree)
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
            # float32 runs: the exact-gradient kernel; float64 runs: its
            # plain version in float64 (the JAX package's float64 path)
            err = energy_norm_error(self.forest, self.tab_lap, self.solution,
                                    self.atoms.positions, self.atoms.charges,
                                    self.cfg.r_c, self.device,
                                    dtype=self.dtype)
        self.pcout("Error in FE solution in energy norm:  " + sci10(err))
        return err

    def refine(self):
        cfg = self.cfg
        with self._stage("Refine, solution transfer and sending atoms "
                         "list to child cells"):
            old = self.forest
            new = old.refine(self.flags)
            omap = old_cell_of_new(old, new)
            # children inherit the parent's locality (the p4est
            # attach/unpack of src/step-50.cc:441-456)
            if self.mask is not None:
                self.mask = transfer_cell_mask(old, new, self.mask, omap=omap)
            if self.lists is not None:
                self.lists = transfer_cell_mask(old, new, self.lists,
                                                omap=omap)
            u_new = transfer_solution(old, new, self.solution,
                                      degree=cfg.degree, omap=omap)
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
            (self.forest, self.solution, self.flags, self.mask, self.lists,
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
            dofs = self.forest.dofs_of(cfg.degree)
            by_level = ", ".join(str(ld.n_dofs) for ld in dofs.levels)
            pc(f"   Number of degrees of freedom: {dofs.n_dofs} "
               f"(by level: {by_level})")
            self.assemble_system()
            if cfg.preconditioner == "GMG":
                self.assemble_multigrid()
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
            if self.lammpsinput and self.atoms.n < 300:
                cyc["energy"] = self.postprocess_energy()
            if cfg.problem == "GaussianCharges" and self.lammpsinput:
                cyc["energy_norm_error"] = self.postprocess_energy_norm()
            # the host-loop GMG route's coarse CG, per V-cycle
            cyc["coarse_cg"] = list(getattr(self.gmg, "coarse_iterations",
                                            [])) or None
            cyc["coarse_s"] = getattr(self.gmg, "coarse_seconds", None)
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
