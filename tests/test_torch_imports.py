"""Boundaries of the PyTorch port: it imports neither jax nor the JAX
package, it refuses configurations outside the ported slice, and its entry
points run on the card unless the CPU is asked for (never falling back to
it)."""

import os
import subprocess
import sys

import pytest
import torch

from coulomb_gmg_tpu_torch.config import (golden_gaussian_config,
                                          production_scaling_config)
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch import device as D
from coulomb_gmg_tpu_torch.driver import Simulation, check_slice

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = """
import importlib, pkgutil, sys
import coulomb_gmg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert "coulomb_gmg_tpu_torch.driver" in sys.modules
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
ref = sorted(m for m in sys.modules if m == "coulomb_gmg_tpu"
             or m.startswith("coulomb_gmg_tpu."))
print("MODULES", len(names), "JAX", bad, "REFERENCE", ref)
sys.exit(1 if bad or ref else 0)
"""


def test_port_and_smoke_script_never_import_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run([sys.executable, "-c", _GUARD], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "JAX [] REFERENCE []" in p.stdout


@pytest.mark.parametrize("override", [
    dict(dtype="float64"), dict(degree=2), dict(n_devices=2),
    dict(flag_compute_quadrupole=True), dict(device_operators="off"),
    dict(problem="Step16"), dict(write_vtu=True)])
def test_out_of_slice_configs_raise(override):
    cfg = production_scaling_config(1, dtype="float32").replace(**override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_slice(cfg)


def test_golden_host_path_is_not_the_slice():
    with pytest.raises(NotImplementedError):
        Simulation(golden_gaussian_config(), atoms=nacl_lattice(1),
                   device="cpu")


def test_device_is_explicit():
    """The device defaults to the card: it resolves to cuda where there is
    one and raises "no CUDA device" here; the CPU only when asked for."""
    from coulomb_gmg_tpu_torch.cli import main
    cfg = production_scaling_config(1, dtype="float32")
    if torch.cuda.is_available():
        assert Simulation(cfg, atoms=nacl_lattice(1)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg, atoms=nacl_lattice(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--production", "1"])                 # --device defaults to cuda


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve("cuda")
    cfg = production_scaling_config(1, dtype="float32")
    with pytest.raises(RuntimeError):
        Simulation(cfg, atoms=nacl_lattice(1), device="cuda")


def test_precision_policy_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    D.resolve("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
