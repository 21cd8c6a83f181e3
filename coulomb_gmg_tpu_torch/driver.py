"""Simulation driver of the PyTorch port: the adaptive cycle.

Counterpart of coulomb_gmg_tpu/driver.py.  Per adaptive cycle: mesh
(generate, or refine and transfer), setup (constraints, locality,
densities, moments), assembly, GMG or Jacobi CG solve, Kelly estimate and
marking, output, and the energy postprocess, with the reference's log
lines (src/step-50.cc:104-178, 1464-1573).  Three operator paths, chosen as
the JAX driver chooses them (its ``device_ops_active``, ``use_tpu_cg`` and
``spmd``; the port's device plays the JAX ``tpu_device``):

* **device operators** (:meth:`Simulation.device_ops_active`:
  GaussianCharges, Q1, GMG, unit coefficient, one device and ``use_tpu_cg``;
  ``device_operators="on"`` in either precision, ``"auto"`` in float32, the
  production configuration, config.py:production_scaling_config): the RHS
  and the GMG operators built on the device (solver/device_gmg.py), GMG-CG
  with a matrix-free system matvec (solver/gmg.py): inside iterative
  refinement to a true float64 ``cg_rtol * ||b||`` for float32 with
  ``cg_rtol < 5e-7``, else one solve at ``cg_rtol``;
* **host-assembled** (everything else on one device): the CSR system and
  the level and interface matrices assembled on the device
  (fem/card_assembly.py, solver/multigrid.py), their patterns and values
  read back where host code needs them (the ELL layout), applied on the
  device through the ELL kernel (ops/spmv.py), solved by
  ``TpuGMG`` with ``solve_refined`` or
  ``tpu_cg_solve`` (``use_tpu_cg``: ``solver_backend="tpu_cg"``, or
  ``"auto"`` in float32), else the host-loop ``cg`` with
  ``GMGPreconditioner`` (the reference's SSOR smoother by default) or
  the CG with Jacobi (solver/fused.py:stepped_cg under ``solve_fused``);
* **SPMD** (``n_devices > 1``, parallel/): the system's plan built on
  ``Simulation.device`` (fem/card_assembly.py) and read back once, with
  the density, assembly, Kelly estimate, FE error and energy sharded over
  contiguous SFC cell blocks (parallel/spmd.py), solved by ``ShardedGMG``
  or the sharded Jacobi-CG (parallel/sharded_gmg.py, parallel/sharded.py).
  ``Simulation(spmd_devices=...)`` names each shard's device.

``solve_fused`` (the default) runs every solve but the SSOR route's
as a stepped solve (solver/fused.py): on the card CUDA graphs, the sharded
ones too across several cards of one process (one graph over all of them)
or NCCL ranks, and uncaptured on CPU shards, cards without peer access or
gloo ranks (``SpmdContext.graph_mode``).  ``False`` runs the eager
loops.

Float32 densities come from the tile kernel (``density_tiles``) or the
dense kernel (no locality flag), float64 ones and ``density_tiles=False``
from the mask and list branches of ops/density.py:compute_density.  The
forest (its refinement and balance) and the constraints, the SPMD assembly
tables, atom lists and output stay on the host in numpy; the cycle's derived
topology is torch code on ``Simulation.device`` (``Forest.device``): the
DoF numbering with its hanging nodes and level DoFs (mesh/dofs.py), the
solution transfer (adapt/transfer.py), the level topology and copy maps
of the device GMG (ops/stencil.py, solver/device_gmg.py), and the face
plans, Kelly estimate and marking (adapt/estimator.py).  Host consumers
read those arrays through one host copy each (``DofInfo.host``).
``Simulation.timer`` (utils/timer.py) is the run's tracer: the stages and
the spans of the layers below them, and the counted uploads and host reads.
``write_vtu`` writes one VTU
piece per shard, a PVTU and a VisIt record per cycle (io/vtu.py), and the
gnuplot grid scripts in 2D (io/gnuplot.py).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (
    build_face_plan, update_face_plan, estimate, mark_cells)
from coulomb_gmg_tpu_torch.adapt.transfer import (
    old_cell_of_new, transfer_cell_mask, transfer_solution)
from coulomb_gmg_tpu_torch.config import Config
from coulomb_gmg_tpu_torch.device import resolve, upload
from coulomb_gmg_tpu_torch.fem import card_assembly
from coulomb_gmg_tpu_torch.fem.constraints import (build_constraints,
                                                   distribute, set_zero)
from coulomb_gmg_tpu_torch.fem.integrals import rhs_cells
from coulomb_gmg_tpu_torch.io.gnuplot import grid_output_debug
from coulomb_gmg_tpu_torch.io.lammps import AtomData, read_lammps_file
from coulomb_gmg_tpu_torch.io.vtu import (nodal_gradient, write_pvtu,
                                          write_visit_record, write_vtu)
from coulomb_gmg_tpu_torch.mesh.dofs import restrict_to_vertices
from coulomb_gmg_tpu_torch.mesh.forest import Forest, to_host
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from coulomb_gmg_tpu_torch.utils.logging import Pcout, sci10, fix10
from coulomb_gmg_tpu_torch.utils.platform import world_size
from coulomb_gmg_tpu_torch.utils.timer import TimerOutput, span, spanned
from coulomb_gmg_tpu_torch.models import problems as P
from coulomb_gmg_tpu_torch.ops.density import (
    atom_masks, cell_quad_points, compute_density, density_bruteforce)
from coulomb_gmg_tpu_torch.ops.ell import ell_mv
from coulomb_gmg_tpu_torch.ops.neighbors import atom_lists
from coulomb_gmg_tpu_torch.ops.smoothers import make_jacobi
from coulomb_gmg_tpu_torch.ops.spmv import CSR
from coulomb_gmg_tpu_torch.ops.tile_density import density_locality_tiles
from coulomb_gmg_tpu_torch.parallel.sharded import (
    ShardedCSR, make_sharded_solver, put_blocks, shard_vector, sharded_diag)
from coulomb_gmg_tpu_torch.parallel.sharded_gmg import ShardedGMG
from coulomb_gmg_tpu_torch.parallel.spmd import (SpmdContext,
                                                 electrostatic_energy_spmd)
from coulomb_gmg_tpu_torch.postprocess.energy import (electrostatic_energy,
                                                      energy_norm_error)
from coulomb_gmg_tpu_torch.solver.cg import cg, host_array, host_float
from coulomb_gmg_tpu_torch.solver.fused import stepped_cg
from coulomb_gmg_tpu_torch.solver.device_gmg import (StencilGMG,
                                                     solve_refined_device)
from coulomb_gmg_tpu_torch.solver.multigrid import build_gmg
from coulomb_gmg_tpu_torch.solver.tpu_cg import tpu_cg_solve
from coulomb_gmg_tpu_torch.solver.tpu_gmg import TpuGMG, solve_refined


class Simulation:
    """One adaptive simulation (the reference's LaplaceProblem).

    ``device`` defaults to "cuda", the hand kernels on the card, and
    raises without one; "cpu" runs their plain PyTorch versions (tests).
    With ``n_devices > 1``, ``spmd_devices`` lists the shards' devices
    (default: one visible CUDA device per shard, parallel/spmd.py)."""

    def __init__(self, cfg: Config, atoms: AtomData = None, device="cuda",
                 pcout=None, spmd_devices=None):
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
        self.use_tpu_cg = (cfg.solver_backend == "tpu_cg" or
                           (cfg.solver_backend == "auto"
                            and self.dtype == torch.float32))
        self.spmd = None
        if cfg.n_devices > 1:
            if world_size() > 1:
                raise NotImplementedError(
                    f"n_devices={cfg.n_devices} across {world_size()} "
                    "processes: the SPMD pipeline runs in one process "
                    "(parallel/spmd.py); across processes only the sharded "
                    "solvers run (parallel/multihost.py)")
            self.spmd = SpmdContext(cfg.n_devices, spmd_devices)
            self.use_tpu_cg = False
        self.device_ops = self.device_ops_active()
        self.forest: Forest = None
        self.solution = None
        self.flags = None
        self.mask = None             # (cells, atoms) locality (<= 64 atoms)
        self.lists = None            # (cells, K) atom lists (> 64 atoms)
        self.error_per_cell = None
        self.gmg = None              # StencilGMG, level GMG or ShardedGMG
        self.A = None                # the assembled system (host path)
        self.cg_passes = None        # CG iterations per refinement pass
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
        """Timed pipeline stage, a span of the run's tracer; device work is
        synchronized at its end so the seconds are the stage's own."""
        sync = ((lambda: torch.cuda.synchronize(self.device))
                if self.device.type == "cuda" else None)
        with self.timer.scope(name, sync) as stage:
            yield
        self._stages[name] = self._stages.get(name, 0.0) + stage.seconds

    # ------------------------------------------------------------ meshing

    @spanned("topology.mesh")
    def make_initial_mesh(self) -> Forest:
        cfg = self.cfg
        if cfg.problem == "Step16":
            # hyper_cube + refine_global (src/step-50.cc:1496-1497)
            return Forest.hyper_cube(cfg.dim, cfg.domain_left,
                                     cfg.domain_right,
                                     cfg.n_global_refinements, self.device)
        # subdivided rectangle with vacuum margin (src/step-50.cc:1504-1526)
        a = 2.0 * cfg.mesh_size_h
        N = (cfg.domain_right - cfg.domain_left) / a
        M = cfg.vacuum_repetitions
        reps = int(round(2 * (N + 2 * M)))
        lower = np.full(cfg.dim, cfg.domain_left - M * a)
        return Forest.uniform(cfg.dim, reps, lower, cfg.mesh_size_h,
                              self.device)

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

    def device_ops_active(self) -> bool:
        """Device-operator mode (solver/device_gmg.py), the eligibility of
        the JAX driver's ``device_ops_active``: "off" never, "on" whenever
        the stencil form can express the operator, "auto" then only in
        float32 (the port's device plays the JAX ``tpu_device``)."""
        cfg = self.cfg
        eligible = (cfg.problem == "GaussianCharges" and cfg.degree == 1
                    and cfg.preconditioner == "GMG" and self.spmd is None
                    and self.use_tpu_cg and self.coeff_fn() is None)
        if cfg.device_operators == "off":
            return False
        if cfg.device_operators == "on":
            return eligible
        return eligible and self.dtype == torch.float32

    def _tiles(self) -> bool:
        """The single-device float32 locality density by the tile kernel
        (``density_tiles``; the JAX driver's ``use_tiles`` without its TPU
        placement floors)."""
        cfg = self.cfg
        return (self.spmd is None and self.dtype == torch.float32
                and cfg.flag_rhs_assembly and cfg.density_tiles)

    # -------------------------------------------------------------- setup

    def _density(self):
        """(n_cells + 1, n_q) density on the device (last row zero)."""
        cfg, f, at = self.cfg, self.forest, self.atoms
        c_pad = f.n_cells + 1
        cut = cfg.nonzero_radius * cfg.r_c
        mask = self.mask if cfg.flag_rhs_assembly else None
        lists = self.lists if cfg.flag_rhs_assembly else None
        if self.spmd is not None:
            # the tile kernel per shard for float32 with locality lists,
            # else the mask, list or all-atom branch per shard
            if (cfg.density_tiles and cfg.flag_rhs_assembly
                    and self.lists is not None
                    and self.dtype == torch.float32):
                rho = self.spmd.density_tiles(f, self.tab_rhs.points,
                                              at.positions, at.charges,
                                              cfg.r_c, cut)
            else:
                rho = self.spmd.density(f, self.tab_rhs.points,
                                        at.positions, at.charges, cfg.r_c,
                                        mask=mask, lists=lists,
                                        dtype=self.dtype)
            rho = rho.to(self.device)
            return torch.cat([rho, rho.new_zeros(1, rho.shape[1])])
        if self._tiles():
            return density_locality_tiles(
                f, self.tab_rhs.points, at.positions, at.charges, cfg.r_c,
                cut, self.device, c_pad=c_pad)
        if self.dtype == torch.float32 and not cfg.flag_rhs_assembly:
            with span("density.kernel"):
                return density_bruteforce(f, self.tab_rhs.points,
                                          at.positions, at.charges, cfg.r_c,
                                          self.device, c_pad=c_pad)
        # runs of the tpu_cg route evaluate it in float32 in either
        # precision, as the JAX driver does; every other run in float64
        dt = torch.float32 if self.use_tpu_cg else torch.float64
        with span("density.kernel"):
            rho = compute_density(f, self.tab_rhs.points, at.positions,
                                  at.charges, cfg.r_c, self.device,
                                  mask=mask, lists=lists, dtype=dt)
        return torch.cat([rho, rho.new_zeros(1, rho.shape[1])])

    def setup(self):
        cfg = self.cfg
        f = self.forest
        with self._stage("Setup system"), span("topology.dofs"):
            dofs = f.dofs_of(cfg.degree)
        if self.lammpsinput:
            # the locality of the JAX host path: a dense mask up to 64
            # atoms, padded lists above (the tile plan makes its own)
            if (cfg.flag_rhs_assembly and not self._tiles()
                    and self.mask is None and self.lists is None):
                with self._stage("RHS assembly optimization"), \
                        span("density.plan"):
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
        with self._stage("Setup system"), span("topology.constraints"):
            self.constraints = build_constraints(dofs, self.boundary_fn())
            if self.device_ops:
                self.plan = None
            else:
                # the CSR pattern and each slot's entries, on the device
                self.plan = card_assembly.plan(
                    dofs.cell2dof, card_assembly.card_constraints(
                        self.constraints, self.device), rhs=True)

    # ----------------------------------------------------------- assembly

    def assemble_system(self):
        cfg = self.cfg
        f = self.forest
        if self.device_ops:
            with self._stage("Assemble Multigrid"):
                if isinstance(self.gmg, StencilGMG):
                    self.gmg.release()      # the last cycle's graphs
                self.gmg = StencilGMG(f, f.dofs_of(1), self.constraints,
                                      self.device, self.dtype,
                                      cache=self._stencil_cache,
                                      coarse_maxiter=cfg.coarse_max_iters,
                                      coarse_rtol=cfg.coarse_rtol,
                                      fused=cfg.solve_fused)
            with self._stage("Assemble system"):
                self.rhs = self.gmg.assemble_rhs(self.rho.to(self.device),
                                                 self.tab_rhs)
            return
        with self._stage("Assemble system"), span("assembly.csr"):
            np_dtype = np.float32 if self.dtype == torch.float32 \
                else np.float64
            h = f.cell_h()
            coeff_q = None
            if self.coeff_fn() is not None:
                pts = cell_quad_points(f, self.tab_lap.points)
                coeff_q = self.coeff_fn()(torch.from_numpy(pts)).numpy()
            if self.spmd is not None:
                # per-shard element tensors, gathered into the CSR slots
                # and summed over the shards (the compress of
                # src/step-50.cc:831-832)
                asm = self.spmd.build_assembler(
                    self.plan, self.tab_lap, self.tab_rhs,
                    has_coeff=coeff_q is not None, np_dtype=np_dtype)
                data, rhs = asm(h, coeff_q, self.rho_host())
            else:
                # the card's element integrals and ordered CSR sums
                hd = upload(h, self.device)
                k = card_assembly.cell_matrices(self.tab_lap, hd, coeff_q,
                                                self.dtype)
                f_cells = rhs_cells(self.tab_rhs, hd,
                                    self.rho[: f.n_cells].to(self.device),
                                    dtype=self.dtype)
                data, rhs = card_assembly.assemble(self.plan, k, f_cells,
                                                   self.dtype)
                rhs = to_host(rhs)
            self.plan.release()
            self.A = CSR.from_pattern(self.plan.pattern.indptr,
                                      self.plan.pattern.indices, data,
                                      device=self.device)
            self.rhs = rhs

    def assemble_multigrid(self):
        cfg = self.cfg
        if self.device_ops:
            return                  # StencilGMG was built with the system
        with self._stage("Assemble Multigrid"):
            self.gmg = self.level_gmg()
            if self.spmd is not None:
                # the per-shard level operators and halo plans, with
                # ShardedGMG's own defaults for the coarse CG
                self.gmg = ShardedGMG(self.gmg, self.A, self.spmd,
                                      dtype=self.dtype,
                                      maxiter=cfg.cg_max_iters,
                                      fused=cfg.solve_fused)

    def level_gmg(self):
        """The level-matrix GMG of the current mesh (solver/multigrid.py),
        the host smoother only where it smooths: TpuGMG and ShardedGMG
        build their own (Chebyshev) smoothers from the levels."""
        cfg = self.cfg
        host_smoother = not self.use_tpu_cg and self.spmd is None
        return build_gmg(
            self.forest, self.forest.dofs_of(cfg.degree), self.tab_lap,
            coeff_fn=self.coeff_fn(),
            smoother=cfg.smoother if host_smoother else "none",
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
                self._solve_device_ops()
                return
            with span("solve.cg"):
                x, k, res0, resf = self._solve_assembled()
            self.cg_passes = None
            with span("solve.check"):
                # the true residual of the returned solution, float64
                A64 = self.A.ell(dtype=torch.float64)
                xd = upload(x, self.device)
                bd = upload(np.asarray(self.rhs, np.float64), self.device)
                self.residual = host_float(torch.linalg.vector_norm(
                    bd - ell_mv(*A64, xd)))
                absd = np.abs(self.A.data_np()).astype(np.float64)
                colsum = np.bincount(self.A.indices, weights=absd,
                                     minlength=self.A.n_cols)
                mat = {"l1_mat": float(colsum.max()),
                       "linf_mat": float(np.add.reduceat(
                           absd, self.A.indptr[:-1]).max()),
                       "fro_mat": float(np.sqrt((absd ** 2).sum()))}
                self._log_solve(np.asarray(self.rhs), x, k, res0, resf, mat)

    def _solve_device_ops(self):
        """The device-operator solve (the JAX driver's solve,
        driver.py:479-509): iterative refinement against the float64 RHS
        for float32 below the float32 CG floor (``cg_rtol < 5e-7``), else
        one GMG-CG at ``cg_rtol``; the true float64 residual either way."""
        cfg, g = self.cfg, self.gmg
        with span("solve.check"):
            b = host_array(self.rhs[: g.n])
        x0 = (self.solution if self.solution is not None
              and len(self.solution) == g.n else None)
        if self.dtype == torch.float32 and cfg.cg_rtol < 5e-7:
            x, k, res0, resf, self.cg_passes = solve_refined_device(
                g, x0, rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters)
            self.residual = float(resf)
        else:
            b64 = g.b64
            x0w = torch.zeros_like(b64)
            if x0 is not None:
                x0w[: g.n] = upload(np.asarray(x0, np.float64), b64.device)
            with span("solve.cg"):
                xw, k, res0, resf = g.solve(
                    b64.to(g.dtype), x0w.to(g.dtype), rtol=cfg.cg_rtol,
                    maxiter=cfg.cg_max_iters,
                    rhs_norm=host_float(torch.linalg.vector_norm(b64)))
            with span("solve.check"):
                x64 = xw.to(torch.float64)
                self.residual = host_float(
                    torch.linalg.vector_norm(g.defect64(x64)))
                x = host_array(x64[: g.n])
            self.cg_passes = [k]
        with span("solve.check"):
            self._log_solve(b, x, k, res0, resf)

    def _solve_assembled(self):
        """The routes of the host-assembled system (the JAX driver's solve,
        src/step-50.cc:938-1017).  Returns (x float64 numpy, iterations,
        |r0|, |r|)."""
        cfg = self.cfg
        rhs = np.asarray(self.rhs)
        x0 = (self.solution if self.solution is not None
              and len(self.solution) == self.A.n_rows else None)
        if self.spmd is not None:
            return self._solve_spmd(rhs, x0)
        if self.use_tpu_cg and cfg.preconditioner == "GMG":
            g = TpuGMG(self.gmg, self.A, self.forest, self.device,
                       dtype=self.dtype,
                       use_dst=(cfg.problem == "GaussianCharges"
                                and cfg.degree == 1),
                       host_cache=self._tpu_host_cache,
                       fused=cfg.solve_fused)
            try:
                if self.dtype == torch.float32 and cfg.cg_rtol < 5e-7:
                    # a float32 CG recurrence saturates near 6e-7 relative:
                    # iterative refinement with a float64 defect
                    return solve_refined(g, self.A, rhs, x0,
                                         rtol=cfg.cg_rtol,
                                         maxiter=cfg.cg_max_iters)
                x, k, res0, resf = g.solve(rhs, x0, rtol=cfg.cg_rtol,
                                           maxiter=cfg.cg_max_iters)
                return x.cpu().numpy().astype(np.float64), k, res0, resf
            finally:
                g.release()
        if self.use_tpu_cg:
            x, k, res0, resf = tpu_cg_solve(
                self.A.rowids, self.A.indices, self.A.data_np(), rhs, x0,
                rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters * 10,
                device=self.device, dtype=self.dtype, fused=cfg.solve_fused)
            return x.astype(np.float64), k, res0, resf
        put = lambda a: upload(np.asarray(a), self.device, self.dtype)
        # the SSOR GMG route runs in the host loop, as JAX's
        # cg(host=True); Jacobi in the stepped solve, as JAX's host=False
        if cfg.preconditioner == "GMG":
            solve, precond = cg, self.gmg
        else:
            solve = stepped_cg if cfg.solve_fused else cg
            precond = make_jacobi(self.A, cfg.jacobi_damping)
        res = solve(self.A.matvec, put(rhs),
                    x0=put(x0) if x0 is not None else None, precond=precond,
                    tol=cfg.cg_rtol * float(np.linalg.norm(rhs)),
                    maxiter=cfg.cg_max_iters)
        return (host_array(res.x).astype(np.float64), res.iterations,
                res.initial_residual, res.final_residual)

    def _solve_spmd(self, rhs, x0):
        """The SPMD solve (the JAX driver's driver.py:543-584): ShardedGMG
        for GMG, the sharded Jacobi-CG otherwise (src/step-50.cc:996-1005)."""
        cfg, spmd = self.cfg, self.spmd
        if cfg.preconditioner == "GMG":
            try:
                return self.gmg.solve(rhs, x0, rtol=cfg.cg_rtol)
            finally:
                self.gmg.release()
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        As = ShardedCSR.from_coo(self.A.rowids, self.A.indices,
                                 self.A.data_np().astype(np_dtype),
                                 self.A.n_rows, spmd.D)
        solver = make_sharded_solver(spmd, As, sharded_diag(As, spmd.D),
                                     tol_rtol=cfg.cg_rtol,
                                     maxiter=cfg.cg_max_iters * 10,
                                     damping=cfg.jacobi_damping,
                                     fused=cfg.solve_fused)
        rhs_b = put_blocks(shard_vector(np.asarray(rhs, np_dtype), spmd.D),
                           spmd)
        x0_b = (put_blocks(shard_vector(np.asarray(x0, np_dtype), spmd.D),
                           spmd) if x0 is not None
                else [torch.zeros_like(r) for r in rhs_b])
        xb, k, res0, resf = solver(rhs_b, x0_b)
        x = torch.cat([v.cpu() for v in xb]).numpy()[: self.A.n_rows]
        return x.astype(np.float64), k, res0, resf

    # --------------------------------------------------------- adaptivity

    def estimate_and_mark(self):
        cfg = self.cfg
        with self._stage("Estimate error and mark cells"):
            if self._face_plan is None:
                with span("estimate.face_plan"):
                    self._face_plan = build_face_plan(self.forest)
            dofs = self.forest.dofs_of(cfg.degree)
            if (self.spmd is not None and not cfg.estimator_volume_term
                    and cfg.degree == 1):
                # Kelly face jumps sharded over the shards
                # (src/step-50.cc:1020-1090), from host gather tables
                err = torch.from_numpy(self.spmd.estimate(
                    self.forest, dofs.host.cell2dof,
                    np.asarray(self.solution), plan=self._face_plan))
            else:
                rho_q = (self.rho[: self.forest.n_cells]
                         if cfg.estimator_volume_term else None)
                err = estimate(self.forest, dofs.cell2dof,
                               np.asarray(self.solution), rho_q,
                               self.tab_rhs.points, self.tab_rhs.weights,
                               degree=cfg.degree,
                               use_volume_term=cfg.estimator_volume_term,
                               plan=self._face_plan)
            self.error_per_cell = err
            flags, self.threshold = mark_cells(err,
                                               cfg.refine_fraction_of_max)
            self.flags = to_host(flags)      # Forest.refine is host numpy
        self.pcout("Threshold value for refinement:\t"
                   + sci10(self.threshold))

    # -------------------------------------------------------- postprocess

    def postprocess_energy(self):
        with self._stage("Postprocess electrostatic energy"):
            args = (self.forest, self.solution, self.atoms.positions,
                    self.atoms.charges, self.cfg.r_c)
            if self.spmd is not None:
                # each atom evaluated by the shard that owns its cell
                # (src/step-50.cc:1334-1398)
                e = electrostatic_energy_spmd(self.spmd, *args,
                                              degree=self.cfg.degree)
            else:
                e = electrostatic_energy(*args, degree=self.cfg.degree)
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
            args = (self.forest, self.tab_lap, self.solution,
                    self.atoms.positions, self.atoms.charges, self.cfg.r_c)
            if self.spmd is not None:
                err = self.spmd.energy_norm_error(*args, dtype=self.dtype)
            else:
                err = energy_norm_error(*args, self.device, dtype=self.dtype)
        self.pcout("Error in FE solution in energy norm:  " + sci10(err))
        return err

    def output_results(self, cycle: int):
        """VTU / PVTU / VisIt output of one cycle (src/step-50.cc:1149-1308,
        the JAX driver's ``output_results``); the optional fields follow
        the reference's flags.  One VTU piece per shard, with the shard's
        own cells."""
        cfg = self.cfg
        f = self.forest
        pos = f.dofs.host.positions
        t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        # vertex-based: higher-degree solutions are restricted to their
        # vertex values
        u_vtx = restrict_to_vertices(f, f.dofs_of(cfg.degree), self.solution)
        point_data = {"solution": u_vtx, "grad_phi": nodal_gradient(f, u_vtx)}
        few_atoms = self.lammpsinput and self.atoms.n < 10
        if cfg.flag_analytical_solution and cfg.problem == "GaussianCharges":
            if few_atoms:
                point_data["Analytical_Solution_atoms"] = P.analytic_solution(
                    t64(pos), t64(self.atoms.positions),
                    t64(self.atoms.charges), cfg.r_c).numpy()
            elif not self.lammpsinput:
                point_data["Analytical_Solution_without_lammps"] = \
                    P.analytic_solution_without_lammps(t64(pos),
                                                       cfg.r_c).numpy()
        if cfg.flag_rhs_field and few_atoms:
            point_data["interpolated_rhs"] = (
                P.gaussian_rhs(t64(pos), cfg.r_c)
                if cfg.problem == "GaussianCharges"
                else P.step16_rhs(t64(pos))).numpy()
        owners = (self.spmd.owners(f.n_cells) if self.spmd is not None
                  else np.zeros(f.n_cells, np.int32))
        cell_data = {"subdomain": owners.astype(np.float64)}
        if self.error_per_cell is not None and \
                len(self.error_per_cell) == f.n_cells:
            cell_data["error_indicator"] = to_host(self.error_per_cell)
        if cfg.flag_atoms_support and self.lammpsinput and \
                cfg.flag_rhs_assembly and self.mask is not None:
            for i in range(self.atoms.n):
                cell_data[f"support_{i}"] = self.mask[:, i].astype(np.float64)
        base = os.path.join(cfg.output_dir, f"solution-{cycle:05d}")
        D = self.spmd.D if self.spmd is not None else 1
        pieces = []
        for d in range(D):
            piece = f"{base}.{d:04d}.vtu"
            cells = np.where(owners == d)[0] if D > 1 else None
            write_vtu(piece, f, point_data, cell_data, cells=cells)
            pieces.append(piece)
        write_pvtu(f"{base}.pvtu", pieces, point_names=list(point_data),
                   cell_names=list(cell_data))
        write_visit_record(f"{base}.visit", pieces)

    def refine(self):
        cfg = self.cfg
        with self._stage("Refine, solution transfer and sending atoms "
                         "list to child cells"):
            old = self.forest
            with span("topology.refine"):
                new = old.refine(self.flags)
            with span("topology.transfer"):
                omap = old_cell_of_new(old, new)
                # children inherit the parent's locality (the p4est
                # attach/unpack of src/step-50.cc:441-456)
                if self.mask is not None:
                    self.mask = transfer_cell_mask(old, new, self.mask,
                                                   omap=omap)
                if self.lists is not None:
                    self.lists = transfer_cell_mask(old, new, self.lists,
                                                    omap=omap)
                u_new = to_host(transfer_solution(
                    old, new, self.solution, degree=cfg.degree, omap=omap))
            if self._face_plan is not None:
                with span("estimate.face_plan"):
                    self._face_plan = update_face_plan(old, new,
                                                       self._face_plan, omap)
            self.forest = new
            self.solution = u_new
            # free the old mesh's DoF records now, not at the collector's
            # next run, so that the card's peak is the same in every run
            old.drop_dofs()
        self.setup()
        self.solution = set_zero(self.constraints, self.solution)

    # ---------------------------------------------------------------- run

    def run(self):
        """The adaptive cycles: one run of the tracer (``self.timer``),
        whose summary joins utils/timer.py:RUNS when it ends."""
        with self.timer.run():
            return self._run()

    def _run(self):
        cfg = self.cfg
        pc = self.pcout
        pc(f"Running with PyTorch on {self.device}")
        pc(f"Dimension:\t{cfg.dim}")
        start_cycle = 0
        if cfg.resume_from:
            from coulomb_gmg_tpu_torch.utils.checkpoint import load_checkpoint
            (forest, self.solution, self.flags, self.mask, self.lists,
             done) = load_checkpoint(cfg.resume_from)
            self.forest = forest.on(self.device)
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
            self.timer.cells.append(self.forest.n_cells)
            dofs = self.forest.dofs_of(cfg.degree)
            by_level = ", ".join(str(ld.n_dofs) for ld in dofs.levels)
            pc(f"   Number of degrees of freedom: {dofs.n_dofs} "
               f"(by level: {by_level})")
            if cfg.dim == 2 and cfg.write_vtu:
                # the 2D grid scripts of src/step-50.cc:1542-1543, under
                # the same switch as the VTU output
                with self._stage("Output"):
                    grid_output_debug(self.forest, self.mask, cycle, cfg.dim,
                                      cfg.output_dir)
            self.assemble_system()
            if cfg.preconditioner == "GMG":
                self.assemble_multigrid()
            self.solve()
            self.estimate_and_mark()
            if cfg.write_vtu:
                with self._stage("Output"):
                    self.output_results(cycle)
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
