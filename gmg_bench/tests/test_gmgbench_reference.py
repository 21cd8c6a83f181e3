"""The plain reference against the program's plain path at 8 atoms on the
CPU, and the control at a size a test run holds.

At this size the float32 cell's program reads about 1.1e-7 by the
reference's float64 system (its density is evaluated in float32) and the
float64 cell's far less; the reference's own solution in the precision
below the cell's reads above the cell's limit."""

import numpy as np
import pytest
import torch

from gmg_bench import cells, check, inputs
from gmg_bench.control import control_snapshots
from gmg_bench.reference import fem
from gmg_bench.reference.density import density_at, member_table
from gmg_bench.run import Solver

PUBLISHED = [85184, 85744]


CELLS = ["nacl64k_f32.production", "nacl1k_f64.production"]


def tiny_settings(cell: str) -> dict:
    """The cell's settings on the 8-atom lattice, two cycles."""
    cfg = cells.find_cell(cell).config
    return dict(cfg["settings"], domain_right=1.0, n_adaptive_cycles=2)


@pytest.fixture(scope="module", params=CELLS)
def solved(request):
    s = tiny_settings(request.param)
    order = inputs.Orders(987654321987, 8).next()
    rec, snaps, atoms = Solver(s, "cpu").solve(1, order, snap=True)
    return request.param, s, rec, snaps, atoms


def test_the_reference_holds_the_program_to_its_system(solved):
    cell, s, rec, snaps, atoms = solved
    assert rec["cells"] == PUBLISHED
    limits = cells.find_cell(cell).limits
    checks, correct = check.compare(snaps, atoms.positions, atoms.charges,
                                    s, PUBLISHED, limits, 0, "cpu")
    assert correct, checks
    assert checks["residual_max"]["value"] < 3e-7
    assert checks["dof_mismatch"]["value"] == 0


def test_an_altered_solution_fails(solved):
    cell, s, rec, snaps, atoms = solved
    bad = [dict(c) for c in snaps]
    u = bad[-1]["solution"].copy()
    u[len(u) // 2] += 0.1 * np.abs(u).max()
    bad[-1]["solution"] = u
    limits = cells.find_cell(cell).limits
    checks, correct = check.compare(bad, atoms.positions, atoms.charges, s,
                                    PUBLISHED, limits, 0, "cpu")
    assert not correct and checks["residual_max"]["value"] > \
        limits["residual_max"]


CONTROL = {"float32": torch.bfloat16, "float64": torch.float32}


def test_the_control_fails_the_limit(solved):
    cell, s, rec, snaps, atoms = solved
    ctl, its = control_snapshots(snaps, atoms.positions, atoms.charges, s,
                                 CONTROL[s["dtype"]], "cpu", maxiter=2000)
    limits = cells.find_cell(cell).limits
    checks, correct = check.compare(ctl, atoms.positions, atoms.charges, s,
                                    PUBLISHED, limits, 0, "cpu")
    assert not correct
    assert checks["residual_max"]["value"] > limits["residual_max"]
    assert checks["dof_mismatch"]["value"] == 0


def test_the_control_in_float64_passes(solved):
    cell, s, rec, snaps, atoms = solved
    ctl, its = control_snapshots(snaps[:1], atoms.positions, atoms.charges,
                                 s, torch.float64, "cpu", maxiter=2000)
    checks, correct = check.compare(ctl, atoms.positions, atoms.charges, s,
                                    PUBLISHED[:1], cells.find_cell(cell).limits,
                                    0, "cpu")
    assert correct, checks
    assert checks["residual_max"]["value"] < 1e-8


def test_density_members_against_every_atom():
    pos, q = (torch.from_numpy(a) for a in inputs.lattice(1))
    mesh = fem.Mesh(44, -5.0, 0.25, np.zeros(44 ** 3, np.int32),
                    np.indices((44,) * 3).reshape(3, -1).T)
    cut = 1.75
    members = member_table(44, -5.0, 0.25, pos, cut)
    rho = density_at(mesh, members, pos, q, 0.5)
    lo = mesh.cell_lower[:, None, :]
    d = pos[None] - lo
    e = d - 0.25
    near = torch.minimum(d * d, e * e).sum(-1) < cut * cut   # (C, A)
    x = mesh.quad_points()
    r2 = ((x[:, :, None, :] - pos[None, None]) ** 2).sum(-1)
    want = (torch.exp(-r2 / 0.25) * (q * near)[:, None, :]).sum(-1)
    want = want * 4 * np.pi / (0.125 * np.pi ** 1.5)
    assert torch.allclose(rho, want, rtol=1e-13, atol=1e-300)
    assert int(members[0][-1]) == int(near.sum())


def test_the_base_grid_is_the_published_one():
    s = cells.find_cell("nacl64k_f32.production").config["settings"]
    assert fem.base_grid(s) == (120, -5.0, 0.25)
    s = cells.find_cell("nacl1k_f64.production").config["settings"]
    assert fem.base_grid(s) == (60, -5.0, 0.25)
