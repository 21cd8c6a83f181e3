"""Output of the PyTorch port: its copy of io/vtu.py and io/gnuplot.py and
``Simulation.output_results``, against the JAX package on the CPU.

The three cases of tests/test_vtu.py run on the copy.  Then both drivers
run the same configurations with ``write_vtu=True`` (live, ~20 s of JAX):
the 8-atom production lattice for one cycle, in float64 with every
optional field (analytic solution, interpolated RHS, atom supports), and
Step16 in 2D for two cycles with its gnuplot grid scripts.  The two output
directories must hold the same files; every VTU array decodes to the same
values (rel 1e-12; both runs are float64 with the same host path), and the
PVTU, VisIt and gnuplot files are equal as text."""

import base64
import os
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu_torch.config import (Config, load_prm,
                                          production_scaling_config)
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.io.lammps import AtomData
from coulomb_gmg_tpu_torch.io.vtu import (nodal_gradient, write_pvtu,
                                          write_visit_record, write_vtu)
from coulomb_gmg_tpu_torch.mesh.forest import Forest
from coulomb_gmg_tpu_torch.models.atoms import nacl_lattice
from coulomb_gmg_tpu_torch.utils.logging import Pcout
from torch_parity import ROOT

torch.set_num_threads(2)

_NP = {"Float64": np.float64, "Float32": np.float32, "Int64": np.int64,
       "Int32": np.int32, "UInt8": np.uint8}


def read_vtu(path):
    """(piece attributes, {array name: decoded array}) of a VTU file."""
    root = ET.parse(path).getroot()
    piece = root.find(".//Piece")
    arrays = {}
    for da in root.iter("DataArray"):
        name = da.get("Name") or "Points"
        dt = _NP[da.get("type")]
        text = da.text.strip()
        if da.get("format") == "ascii":
            a = np.array(text.split(), dtype=dt)
        else:
            header = np.frombuffer(base64.b64decode(text[:44]), np.uint64)
            a = np.frombuffer(zlib.decompress(base64.b64decode(text[44:])),
                              dt)
            assert header[1] == a.nbytes
        arrays[name] = a
    return dict(piece.attrib), arrays


# ---------------------------------------------------------------------------
# the three cases of tests/test_vtu.py, on the copy
# ---------------------------------------------------------------------------

def test_vtu_roundtrip(tmp_path):
    f = Forest.uniform(3, 4, np.zeros(3), 0.25)
    u = np.linspace(0.0, 1.0, f.dofs.n_dofs)
    grad = nodal_gradient(f, u)
    piece = str(tmp_path / "solution-00000.0000.vtu")
    write_vtu(piece, f, {"solution": u, "grad_phi": grad},
              {"subdomain": np.zeros(f.n_cells)})
    root = ET.parse(piece).getroot()
    assert root.tag == "VTKFile"
    assert int(root.find(".//Piece").get("NumberOfCells")) == f.n_cells
    names = {d.get("Name") for d in root.findall(".//DataArray")}
    assert {"solution", "grad_phi", "subdomain"} <= names
    master = str(tmp_path / "solution-00000.pvtu")
    write_pvtu(master, [piece], point_names=["solution", "grad_phi"],
               cell_names=["subdomain"])
    proot = ET.parse(master).getroot()
    assert proot.tag == "VTKFile"
    assert len(proot.findall(".//Piece")) == 1
    visit = str(tmp_path / "solution-00000.visit")
    write_visit_record(visit, [piece])
    assert os.path.getsize(visit) > 0


def test_nodal_gradient_linear_field_exact():
    f = Forest.uniform(3, 5, np.zeros(3), 0.2)
    pos = f.dofs.positions
    u = 2 * pos[:, 0] - 3 * pos[:, 1] + pos[:, 2]
    assert np.allclose(nodal_gradient(f, u), -np.array([2.0, -3.0, 1.0]),
                       atol=1e-12)


def test_vtu_binary_encoding_roundtrip(tmp_path):
    f = Forest.uniform(3, 6, np.zeros(3), 1.0 / 6)
    u = np.sin(np.arange(f.dofs.n_dofs, dtype=np.float64))
    pa, pb = str(tmp_path / "a.vtu"), str(tmp_path / "b.vtu")
    write_vtu(pa, f, {"solution": u}, encoding="ascii")
    write_vtu(pb, f, {"solution": u}, encoding="binary")
    assert os.path.getsize(pb) < 0.5 * os.path.getsize(pa)
    assert ET.parse(pb).getroot().get("compressor") == "vtkZLibDataCompressor"
    _, binary = read_vtu(pb)
    _, ascii_ = read_vtu(pa)
    np.testing.assert_array_equal(binary["solution"], u)
    np.testing.assert_allclose(ascii_["solution"], u, rtol=1e-9)
    ref = f.dofs.cell2dof[:, [0, 1, 3, 2, 4, 5, 7, 6]].reshape(-1)
    np.testing.assert_array_equal(binary["connectivity"], ref)


# ---------------------------------------------------------------------------
# both drivers, the same output
# ---------------------------------------------------------------------------

def _same_output(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        p, j = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if not name.endswith(".vtu"):
            assert open(p).read() == open(j).read(), name
            continue
        (pa, parr), (ja, jarr) = read_vtu(p), read_vtu(j)
        assert pa == ja
        assert list(parr) == list(jarr), name
        for k, ref in jarr.items():
            got = parr[k]
            assert got.dtype == ref.dtype and got.shape == ref.shape, k
            if ref.dtype.kind == "f":
                scale = max(float(np.abs(ref).max()), 1e-300)
                assert float(np.abs(got - ref).max()) <= 1e-12 * scale, k
            else:
                np.testing.assert_array_equal(got, ref)
    return names


def test_8_atoms_output_matches_jax(tmp_path):
    from coulomb_gmg_tpu.config import production_scaling_config as jcfg
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.models.atoms import nacl_lattice as jlattice
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    flags = dict(dtype="float64", n_adaptive_cycles=1, write_vtu=True,
                 flag_analytical_solution=True, flag_rhs_field=True,
                 flag_atoms_support=True)
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    JaxSimulation(jcfg(1, output_dir=str(jd), **flags), atoms=jlattice(1),
                  pcout=JaxPcout(enabled=False)).run()
    Simulation(production_scaling_config(1, output_dir=str(pd), **flags),
               atoms=nacl_lattice(1), device="cpu",
               pcout=Pcout(enabled=False)).run()
    names = _same_output(str(pd), str(jd))
    assert names == ["solution-00000.0000.vtu", "solution-00000.pvtu",
                     "solution-00000.visit"]
    _, arrays = read_vtu(str(pd / "solution-00000.0000.vtu"))
    assert {"solution", "grad_phi", "Analytical_Solution_atoms",
            "interpolated_rhs", "subdomain", "error_indicator",
            "support_0", "support_7"} <= set(arrays)


def test_step16_2d_output_matches_jax(tmp_path):
    from coulomb_gmg_tpu.config import Config as JaxConfig
    from coulomb_gmg_tpu.driver import Simulation as JaxSimulation
    from coulomb_gmg_tpu.io.lammps import AtomData as JaxAtomData
    from coulomb_gmg_tpu.utils.logging import Pcout as JaxPcout
    kw = dict(problem="Step16", dim=2, n_global_refinements=4,
              domain_left=0.0, domain_right=1.0, n_adaptive_cycles=2,
              boundary_conditions="Homogeneous", preconditioner="GMG",
              estimator_volume_term=False, dtype="float64",
              flag_output_time=False, write_vtu=True)
    empty = (np.zeros((0, 2)), np.zeros(0), np.zeros(0, np.int32),
             np.zeros(2), np.zeros(2))
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    JaxSimulation(JaxConfig(output_dir=str(jd), **kw),
                  atoms=JaxAtomData(*empty),
                  pcout=JaxPcout(enabled=False)).run()
    Simulation(Config(output_dir=str(pd), **kw), atoms=AtomData(*empty),
               device="cpu", pcout=Pcout(enabled=False)).run()
    names = _same_output(str(pd), str(jd))
    for c in (0, 1):
        assert f"grid2_p_cycle{c}0.gp" in names
        assert f"grid_atom_presence2_p_cycle{c}0.gp" in names
        assert f"solution-{c:05d}.pvtu" in names


def test_step16_prm_writes_every_cycle(tmp_path, monkeypatch):
    """examples/step-16.prm in float64 on the CPU with write_vtu: the VTU,
    PVTU and VisIt files of both cycles; write_vtu is no .prm key."""
    monkeypatch.chdir(ROOT)
    cfg = load_prm(os.path.join(ROOT, "examples", "step-16.prm"),
                   dtype="float64", write_vtu=True, output_dir=str(tmp_path),
                   n_adaptive_cycles=2)
    sim = Simulation(cfg, device="cpu", pcout=Pcout(enabled=False))
    res = sim.run()
    for r in res:
        base = tmp_path / f"solution-{r['cycle']:05d}"
        attrs, arrays = read_vtu(str(base) + ".0000.vtu")
        assert int(attrs["NumberOfCells"]) == r["n_cells"]
        assert np.isfinite(arrays["solution"]).all()
        assert (tmp_path / (base.name + ".pvtu")).exists()
        assert open(str(base) + ".visit").read().startswith("!NBLOCKS 1")
    from coulomb_gmg_tpu import config as jconfig
    from coulomb_gmg_tpu_torch import config as tconfig
    for schema in (jconfig._SCHEMA, tconfig._SCHEMA):
        assert "write_vtu" not in {field for field, _ in schema.values()}
