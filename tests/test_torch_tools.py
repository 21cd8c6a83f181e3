"""The framework-neutral tools on the port's output, on the CPU:
``tools/parse_logs.py`` reads the port CLI's log of an 8-atom run into the
tables it reads from the JAX CLI's log of the same ``.prm``, and
``tools/plots.py`` writes its gnuplot scripts from the port's cutoff
tables.  Neither tool imports a package; both run as scripts."""

import os
import subprocess
import sys

import pytest

from coulomb_gmg_tpu_torch import rc_sweep
from coulomb_gmg_tpu_torch.io.lammps import write_lammps_file
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the production study's geometry and settings that a .prm can state, on
# the 8-atom lattice (config.py:production_scaling_config(1))
PRM = """subsection Geometry
	set Number of global refinement = 0
	set Domain limit left = 0.0
	set Domain limit right = 1.0
	set Mesh size = 0.25
	set Vacuum repetitions = 10
end
subsection Misc
	set Number of Adaptive Refinement = 2
	set smoothing length = 0.5
	set Nonzero Density radius parameter around each charge = 3.5
	set Flag for RHS evaluation optimization = true
	set Quadrature points for RHS function = 1
end
set Polynomial degree = 1
subsection Solver input data
	set Preconditioner = GMG
end
subsection Problem Selection
	set Problem = GaussianCharges
	set Dimension = 3
	set Boundary conditions selection = Inhomogeneous
end
subsection Lammps data
	set Lammps input file = atom_n1_8.data
end
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **extra)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The log of each CLI on the same .prm, float64 on the CPU."""
    d = tmp_path_factory.mktemp("cli")
    write_lammps_file(str(d / "atom_n1_8.data"), nacl_lattice(1))
    (d / "p8.prm").write_text(PRM)
    runs = {"port": ["-m", "coulomb_gmg_tpu_torch.cli", "p8.prm", "--device",
                     "cpu", "--float64"],
            "jax": ["-m", "coulomb_gmg_tpu.cli", "p8.prm", "--cpu"]}
    out = {}
    for name, argv in runs.items():
        p = subprocess.run([sys.executable, *argv], cwd=d, capture_output=True,
                           text=True, timeout=600,
                           env=_env(JAX_PLATFORMS="cpu"))
        assert p.returncode == 0, p.stderr[-3000:]
        (d / f"{name}.log").write_text(p.stdout)
        out[name] = d / f"{name}.log"
    return out


@pytest.mark.parametrize("kind", ["cg", "ncells"])
def test_parse_logs_reads_the_port_log_as_the_jax_log(logs, kind):
    tables = {}
    for name, log in logs.items():
        p = subprocess.run([sys.executable,
                            os.path.join(ROOT, "tools", "parse_logs.py"),
                            kind, str(log)], capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 0, p.stderr
        tables[name] = open(f"{log}.{kind}.parsed").read()
    assert tables["port"] == tables["jax"]
    _, natoms, *rows = tables["port"].strip().splitlines()
    assert natoms == "8"
    assert [r.split("\t")[0] for r in rows] == ["0", "1"]
    if kind == "ncells":
        assert rows[0] == "0\t85184"


def test_plots_takes_the_port_cutoff_tables(tmp_path):
    rc_sweep.main(["--device", "cpu", "--reps", "4", "--step", "1.0",
                   "--out", str(tmp_path)])
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "plots.py"),
                        "--dir", str(tmp_path)], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    written = p.stdout.split()
    assert {os.path.basename(w) for w in written} >= {"Error_plot.gp"}
    assert all(os.path.isfile(w) for w in written)
    gp = (tmp_path / "Error_plot.gp").read_text()
    assert "'Total_charge_density_AbsErr_L2.dat'" in gp
