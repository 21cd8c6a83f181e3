"""Run configuration.

Mirrors the reference's deal.II ``ParameterHandler`` schema
(``src/step-50.cc:13-96``): five subsections (Geometry, Problem Selection,
Misc, Solver input data, Lammps data) plus the top-level polynomial degree.
Supports construction from a ``.prm`` file, from an in-memory string (the
reference's tests inject prm text the same way, ``tests/gaussian-charges.cc:16-48``),
or programmatically.  Unknown selection values are rejected; missing entries
fall back to declared defaults.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, Optional


_PROBLEMS = ("Step16", "GaussianCharges")
_BCS = ("Homogeneous", "Inhomogeneous", "Exact")
_PRECONDITIONERS = ("GMG", "Jacobi")
_SMOOTHERS = ("ssor", "mc_ssor", "jacobi", "chebyshev")


@dataclass
class Config:
    """Validated runtime parameters.

    Defaults replicate the declared defaults of the reference schema
    (``src/step-50.cc:17-94``).  Extra TPU-framework knobs (dtype, smoother
    selection, device mesh) have no reference counterpart and default to
    values that reproduce reference behavior.
    """

    # --- Geometry (src/step-50.cc:15-31)
    n_global_refinements: int = 2
    domain_left: float = -1.0
    domain_right: float = 1.0
    mesh_size_h: float = 0.25
    vacuum_repetitions: int = 1

    # --- Problem Selection (src/step-50.cc:35-45)
    problem: str = "Step16"
    dim: int = 2
    boundary_conditions: str = "Inhomogeneous"

    # --- Misc (src/step-50.cc:48-77)
    n_adaptive_cycles: int = 2
    r_c: float = 0.5                     # "smoothing length"
    nonzero_radius: float = 3.0          # density cutoff multiplier
    flag_analytical_solution: bool = False
    flag_rhs_field: bool = False
    flag_atoms_support: bool = False
    flag_rhs_assembly: bool = False      # locality-optimized RHS assembly
    quadrature_degree_rhs: int = 1       # extra RHS quadrature points
    flag_output_time: bool = True
    # The reference integrates the quadrupole by quadrature and then
    # explicitly zeroes it (src/step-50.cc:595-624) — the result is dead.
    # Off by default: behavior is identical (BCs are dipole-only either
    # way); enable to reproduce the reference's (discarded) integral.
    flag_compute_quadrupole: bool = False

    # Volume-residual augmentation of the Kelly indicator
    # (src/step-50.cc:1052-1082).  True replicates the CURRENT reference
    # code (the golden test trajectories encode it).  False replicates the
    # estimator that produced the PUBLISHED production scaling study: the
    # Jan-2018 logs behind Plotting/ncells_per_atom.dat and the
    # SSOR_*.o87622x walltimes have no "Estimate error and mark cells"
    # timer section and no "Threshold value" lines — that code revision
    # marked on the plain Kelly indicator, and only plain-Kelly marking
    # reproduces its per-cycle cell counts exactly (85184/85744/87648/
    # 91344/99464 at 8 atoms ... 1728000/1728560/1749672/1785904/1849296
    # at 64k; verified in tests/test_production_trajectory.py).
    estimator_volume_term: bool = True
    # FE-error (energy-norm) postprocess (src/step-50.cc:1423-1461).  The
    # current reference runs it unconditionally; the published scaling
    # logs contain no "energy norm" lines and no "Postprocess FE error"
    # timer section — the production baselines exclude this stage, so the
    # like-for-like scaling benches turn it off.
    flag_postprocess_error: bool = True

    # --- Polynomial degree (src/step-50.cc:80)
    degree: int = 1

    # --- Solver input data (src/step-50.cc:83-88)
    preconditioner: str = "GMG"

    # --- Lammps data (src/step-50.cc:90-95)
    lammps_file: str = "atom_8.data"

    # --- TPU-framework-only knobs (no reference counterpart)
    smoother: str = "ssor"               # ssor | mc_ssor | jacobi | chebyshev
    smoother_damping: float = 0.5        # reference: SSOR damping 0.5 (src/step-50.cc:972)
    smoother_steps: int = 2              # reference: set_steps(2) (src/step-50.cc:973)
    jacobi_damping: float = 0.6          # reference Jacobi path (src/step-50.cc:1001)
    cg_max_iters: int = 500              # reference: SolverControl(500, ...) (src/step-50.cc:942)
    cg_rtol: float = 1e-8                # tol = rtol * ||b|| (src/step-50.cc:942)
    coarse_max_iters: int = 1000         # reference coarse CG (src/step-50.cc:962)
    coarse_tol: float = 1e-10
    coarse_rtol: float = 0.0             # relative floor for f32 runs
    refine_fraction_of_max: float = 0.6  # threshold = 0.6*max (src/step-50.cc:1084)
    dtype: str = "float64"               # float64 for parity tests; float32/bf16 on TPU
    solver_backend: str = "auto"         # auto | gmg | tpu_cg (bucketed TPU kernel)
    output_dir: str = "."
    write_vtu: bool = False
    # the stepped solve of solver/fused.py (the counterpart of the fused
    # whole-solve executable) for StencilGMG, TpuGMG, tpu_cg_solve, the
    # Jacobi CG, ShardedGMG and the sharded Jacobi-CG: on the card CUDA
    # graphs, captured once per operator set, the state read once per
    # step replay (the sharded ones on CPU shards, cards without peer
    # access or gloo ranks: the same steps uncaptured); False runs the
    # eager loops, one read per CG iteration (a measurement aid)
    solve_fused: bool = True
    # chip-resident operators (solver/device_gmg.py): level matrices built
    # ON DEVICE from compact topology (ops/stencil.py), matrix-free outer
    # matvec, device RHS assembly — no host CSR assembly, no ELL ship.
    # Eligible for GaussianCharges / Q1 / unit coefficient / GMG /
    # single-device.  "auto": on for accelerator-visible float32 runs;
    # "on": force (eligibility permitting, any backend — used by tests);
    # "off": never.  The float64 golden-parity path is unaffected by
    # "auto" (it runs host CSR assembly as before).
    device_operators: str = "auto"
    # Morton-tiled locality density (ops/tile_density.py): dense
    # (atom x point) tiles over bucket-sorted atom slices on the
    # accelerator, replacing the gather-bound host list path in float32
    # runs with flag_rhs_assembly.  Exact production semantics
    # (level-0-ancestor membership).  False pins the host list path.
    density_tiles: bool = True
    # checkpoint/resume (a capability the reference lacks, SURVEY 5.4):
    checkpoint_dir: str = ""     # save a resumable snapshot per cycle
    resume_from: str = ""        # path of a snapshot to resume after
    n_devices: int = 1                   # size of the 1-D device mesh for sharded solves

    def __post_init__(self) -> None:
        if self.problem not in _PROBLEMS:
            raise ValueError(
                f"Problem must be one of {_PROBLEMS}, got {self.problem!r}")
        if self.boundary_conditions not in _BCS:
            raise ValueError(
                f"Boundary conditions selection must be one of {_BCS}, "
                f"got {self.boundary_conditions!r}")
        if self.preconditioner not in _PRECONDITIONERS:
            raise ValueError(
                f"Preconditioner must be one of {_PRECONDITIONERS}, "
                f"got {self.preconditioner!r}")
        if self.smoother not in _SMOOTHERS:
            raise ValueError(
                f"smoother must be one of {_SMOOTHERS}, got {self.smoother!r}")
        if self.solver_backend not in ("auto", "gmg", "tpu_cg"):
            raise ValueError(
                f"solver_backend must be auto|gmg|tpu_cg, got {self.solver_backend!r}")
        if self.device_operators not in ("auto", "on", "off"):
            raise ValueError(
                f"device_operators must be auto|on|off, "
                f"got {self.device_operators!r}")
        if self.dim not in (2, 3):
            raise ValueError("Only 2d and 3d dimensions are supported.")
        if self.degree < 1:
            raise ValueError("Polynomial degree must be >= 1")
        if self.smoother == "mc_ssor" and self.degree > 1:
            # 2^dim parity coloring only decouples Q1 stencils; same-color
            # Q_p (p>1) nodes are coupled, degrading the sweep to damped
            # Jacobi on those couplings (ops/smoothers.py:lattice_color).
            import warnings
            warnings.warn(
                "smoother='mc_ssor' uses parity coloring that is exact only "
                "for degree 1; falling back to 'chebyshev' for degree "
                f"{self.degree}", stacklevel=2)
            object.__setattr__(self, "smoother", "chebyshev")

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


# Mapping: (subsection, entry name) -> (Config field, type)
_SCHEMA: Dict[tuple, tuple] = {
    ("Geometry", "Number of global refinement"): ("n_global_refinements", int),
    ("Geometry", "Domain limit left"): ("domain_left", float),
    ("Geometry", "Domain limit right"): ("domain_right", float),
    ("Geometry", "Mesh size"): ("mesh_size_h", float),
    ("Geometry", "Vacuum repetitions"): ("vacuum_repetitions", int),
    ("Problem Selection", "Problem"): ("problem", str),
    ("Problem Selection", "Dimension"): ("dim", int),
    ("Problem Selection", "Boundary conditions selection"): ("boundary_conditions", str),
    ("Misc", "Number of Adaptive Refinement"): ("n_adaptive_cycles", int),
    ("Misc", "smoothing length"): ("r_c", float),
    ("Misc", "Nonzero Density radius parameter around each charge"): ("nonzero_radius", float),
    ("Misc", "Output and calculation of Analytical solution"): ("flag_analytical_solution", bool),
    ("Misc", "Output of RHS field"): ("flag_rhs_field", bool),
    ("Misc", "Output of support of each atom"): ("flag_atoms_support", bool),
    ("Misc", "Flag for RHS evaluation optimization"): ("flag_rhs_assembly", bool),
    ("Misc", "Quadrature points for RHS function"): ("quadrature_degree_rhs", int),
    ("Misc", "Output time summary table"): ("flag_output_time", bool),
    ("", "Polynomial degree"): ("degree", int),
    ("Solver input data", "Preconditioner"): ("preconditioner", str),
    ("Lammps data", "Lammps input file"): ("lammps_file", str),
}


def _coerce(raw: str, typ) -> object:
    raw = raw.strip()
    if typ is bool:
        low = raw.lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        raise ValueError(f"Cannot parse boolean from {raw!r}")
    return typ(raw)


def parse_prm_text(text: str, **overrides) -> Config:
    """Parse deal.II ``.prm`` syntax into a :class:`Config`.

    Handles ``subsection X`` / ``end`` nesting, ``set Name = Value`` lines,
    ``#`` comments, and is whitespace tolerant (the reference prm files mix
    tabs and spaces).  Unknown entries raise, like ``ParameterHandler``.
    """
    values: Dict[str, object] = {}
    stack = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"^subsection\s+(.+?)\s*$", line)
        if m:
            stack.append(m.group(1))
            continue
        if line == "end":
            if not stack:
                raise ValueError(f"line {lineno}: 'end' without subsection")
            stack.pop()
            continue
        m = re.match(r"^set\s+(.+?)\s*=\s*(.*?)\s*$", line)
        if m:
            section = stack[-1] if stack else ""
            name, raw = m.group(1), m.group(2)
            key = (section, name)
            if key not in _SCHEMA:
                raise ValueError(
                    f"line {lineno}: unknown parameter {name!r} in "
                    f"subsection {section!r}")
            fld, typ = _SCHEMA[key]
            values[fld] = _coerce(raw, typ)
            continue
        raise ValueError(f"line {lineno}: cannot parse prm line: {line!r}")
    if stack:
        raise ValueError(f"unterminated subsection(s): {stack}")
    values.update(overrides)
    return Config(**values)


def load_prm(path: str, **overrides) -> Config:
    with open(path) as f:
        return parse_prm_text(f.read(), **overrides)


def golden_gaussian_config(**overrides) -> Config:
    """The configuration of the reference golden regression test
    (``tests/gaussian-charges.cc:16-48``): 2-atom NaCl pair, domain [0,1],
    h=0.25, 10 vacuum repetitions -> 44^3 base cells, Exact BC, 6 cycles."""
    base = dict(
        n_global_refinements=0, domain_left=0.0, domain_right=1.0,
        mesh_size_h=0.25, vacuum_repetitions=10,
        n_adaptive_cycles=6, r_c=0.5, nonzero_radius=3.5,
        flag_rhs_assembly=True, quadrature_degree_rhs=4,
        flag_output_time=False, degree=1, preconditioner="GMG",
        problem="GaussianCharges", dim=3, boundary_conditions="Exact",
        lammps_file="atom_n1_2.data",
    )
    base.update(overrides)
    return Config(**base)


def production_scaling_config(n: int, **overrides) -> Config:
    """The configuration of the reference's PUBLISHED scaling study
    (``SSOR_run.o876223`` / ``SSOR_64k_atoms.o876224`` /
    ``Plotting/ncells_per_atom.dat``): NaCl lattice of ``8*n^3`` atoms in
    box ``[0, n]^3``, h=0.25, 10 vacuum repetitions, GMG, 5 cycles.

    Settings recovered from the logs themselves (the ``*_test.prm`` files
    were not preserved):

    * ``quadrature_degree_rhs=1`` (the schema default) — reproduces the
      8-atom cycle-0 CG starting value 0.670321 exactly; the golden test's
      value 4 gives 0.669442;
    * ``nonzero_radius=3.5`` — reproduces the 8-atom cycle-1 starting
      value 0.1205202179 to 8 significant digits (3.0 drifts at digit 7);
    * plain-Kelly marking (``estimator_volume_term=False``) — the only
      setting that reproduces the published per-cycle cell counts (the
      volume-residual augmentation postdates those runs; see the field's
      docstring);
    * no FE-error postprocess (``flag_postprocess_error=False``) — the
      logs never print "energy norm" lines;
    * default (Inhomogeneous = dipole) boundary conditions.
    """
    base = dict(
        n_global_refinements=0, domain_left=0.0, domain_right=float(n),
        mesh_size_h=0.25, vacuum_repetitions=10,
        n_adaptive_cycles=5, r_c=0.5, nonzero_radius=3.5,
        flag_rhs_assembly=True, quadrature_degree_rhs=1,
        estimator_volume_term=False, flag_postprocess_error=False,
        flag_output_time=False, degree=1, preconditioner="GMG",
        problem="GaussianCharges", dim=3,
        boundary_conditions="Inhomogeneous",
        lammps_file=f"atom_n{n}_{8 * n ** 3}.data",
    )
    base.update(overrides)
    return Config(**base)
