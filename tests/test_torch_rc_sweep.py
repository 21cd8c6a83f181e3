"""The port's cutoff study (coulomb_gmg_tpu_torch/rc_sweep.py) on the CPU:
its four tables against those of the JAX script ``tools/rc_sweep.py`` run
on the same arguments, and the properties of ``tests/test_rc_variation.py``
on the port at that test's 20^3 mesh."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch import rc_sweep

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ["RHS_Norm_value_comparison_L1.dat",
          "RHS_Norm_value_comparison_L2.dat",
          "RHS_Norm_value_comparison_LInfinity.dat",
          "Total_charge_density_AbsErr_L2.dat"]
ARGS = ["--reps", "8", "--step", "0.5"]


def _read(path):
    """(lines without numbers, cutoffs, values)."""
    text, cut, val = [], [], []
    for line in open(path):
        parts = line.split("\t")
        try:
            c, v = float(parts[0]), float(parts[1])
        except (ValueError, IndexError):
            text.append(line)
            continue
        cut.append(c)
        val.append(v)
        text.append("\t".join(f"{len(p.strip())}" for p in parts) + "\n")
    return text, cut, val


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    port = tmp_path_factory.mktemp("port")
    jax_out = tmp_path_factory.mktemp("jax")
    rows = rc_sweep.main(ARGS + ["--device", "cpu", "--out", str(port)])
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "rc_sweep.py"),
                        *ARGS, "--out", str(jax_out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    return rows, port, jax_out


@pytest.mark.parametrize("name", TABLES)
def test_tables_match_the_jax_study(tables, name):
    """Same layout line for line (the numbers' widths included), the same
    cutoffs, every value within 1e-11 absolute."""
    _, port, jax_out = tables
    t_port, c_port, v_port = _read(port / name)
    t_jax, c_jax, v_jax = _read(jax_out / name)
    assert t_port == t_jax
    assert c_port == c_jax == list(np.arange(2.0, 6.0 + 1e-9, 0.5))
    np.testing.assert_allclose(v_port, v_jax, rtol=0, atol=1e-11)


def test_rows_are_the_tables(tables):
    rows, port, _ = tables
    for norm, name in zip(rc_sweep.NORMS + ("charge",), TABLES):
        _, cut, val = _read(port / name)
        assert cut == [round(r["cutoff"], 2) for r in rows]
        digits = 10 if norm == "charge" else 12
        assert val == [round(r[norm], digits) for r in rows]


@pytest.fixture(scope="module")
def study():
    """tests/test_rc_variation.py's mesh: domain [-2, 3]^3, h = 0.25."""
    s = rc_sweep.Study(20, torch.device("cpu"))
    return s, s.rhs()


def test_rhs_error_decays_with_cutoff(study):
    s, (brute, _, _) = study
    errs = [np.linalg.norm(s.rhs(c)[0] - brute) for c in (2.0, 3.0, 4.0)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[1] < 0.05 * errs[0]
    assert errs[2] < 0.05 * errs[1]


def test_rhs_exact_when_cutoff_covers_domain(study):
    s, (brute, _, _) = study
    rhs, _, mask = s.rhs(16.0)
    assert mask.all()
    assert torch.equal(torch.from_numpy(rhs), torch.from_numpy(brute))


def test_total_charge_integral(study):
    s, _ = study
    vals = [abs(s.rhs(c)[1]) for c in (2.0, 4.0)]
    assert vals[0] < 5e-3
    assert vals[1] <= vals[0] + 1e-12


def test_optimized_matches_brute_at_reference_cutoff(study):
    s, (brute, _, _) = study
    rhs = s.rhs(3.5)[0]
    assert np.linalg.norm(rhs - brute) / np.linalg.norm(brute) < 1e-5
