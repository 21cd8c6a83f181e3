"""Boundaries of the PyTorch port: it imports neither jax nor the JAX
package, it routes every configuration to the device-operator, the
host-assembled or the SPMD path, and its entry points run on the card
unless the CPU is asked for (never falling back to it)."""

import os
import subprocess
import sys

import pytest
import torch

from coulomb_gmg_tpu_torch.config import (golden_gaussian_config,
                                          production_scaling_config)
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch import device as D
from coulomb_gmg_tpu_torch.driver import Simulation

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = """
import importlib, pkgutil, sys
import coulomb_gmg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
for name in ("driver", "io.vtu", "io.gnuplot", "parallel.sharded",
             "parallel.sharded_gmg", "parallel.spmd", "parallel.multihost",
             "utils.platform", "solver.fused", "rc_sweep", "bench_kernels",
             "profile_pieces", "profile_enorm", "profile_setup",
             "profile_topology"):
    assert "coulomb_gmg_tpu_torch." + name in sys.modules, name
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
    """Every configuration is accepted now (several devices and output
    included) and routed: the quadrupole and output keep the float32
    production run on the device-operator path, several devices take the
    SPMD path (host-assembled, no use_tpu_cg, as the JAX driver sets it),
    the rest the host-assembled path."""
    cfg = production_scaling_config(1, dtype="float32").replace(**override)
    D = cfg.n_devices
    sim = Simulation(cfg, atoms=nacl_lattice(1), device="cpu",
                     spmd_devices=["cpu"] * D if D > 1 else None)
    device_ops = ("flag_compute_quadrupole" in override
                  or "write_vtu" in override)
    assert sim.device_ops is device_ops
    assert (sim.spmd is not None) == (D > 1)
    assert sim.use_tpu_cg == (cfg.dtype == "float32" and D == 1)
    if D > 1:
        assert sim.spmd.D == D and sim.spmd.devices == [torch.device(
            "cpu")] * D


def test_spmd_devices_default_to_cuda_cards():
    """Without a device list each shard takes its own CUDA card, and too
    few cards is an error, as too few JAX devices is."""
    cfg = production_scaling_config(1, dtype="float64", n_devices=2)
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA cards are present")
    with pytest.raises(RuntimeError, match="CUDA devices are visible"):
        Simulation(cfg, atoms=nacl_lattice(1), device="cpu")


def test_golden_host_path_is_not_the_slice():
    """The golden configuration (float64) runs the host-assembled path with
    the host-loop CG and the reference's SSOR smoother."""
    sim = Simulation(golden_gaussian_config(), atoms=nacl_lattice(1),
                     device="cpu")
    assert not sim.device_ops and not sim.use_tpu_cg
    assert sim.dtype == torch.float64 and sim.cfg.smoother == "ssor"


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
