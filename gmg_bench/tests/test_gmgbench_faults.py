"""The rest of a run, with the timed path broken underneath, comes out
not correct: a solve that returns its state unchanged, half of the atoms
left out of the density, and a solution altered where it is produced.
(A one-card cell has no exchange between cards to leave out.)  Each fault
also reports success through the program's own numbers, so only the
comparison can catch it."""

import numpy as np
import pytest

from coulomb_gmg_tpu_torch import driver
from gmg_bench import cells, run
from gmg_bench.tests.conftest import TINY


def _unchanged(monkeypatch):
    def solve(self):
        x0 = self.solution if self.solution is not None and len(
            self.solution) == self.gmg.n else np.zeros(self.gmg.n)
        self.residual, self.cg_passes = 0.0, [0]
        self._log_solve(self.rhs[: self.gmg.n].cpu().numpy(), x0, 0, 1.0,
                        0.0)
    monkeypatch.setattr(driver.Simulation, "_solve_device_ops", solve)


def _half_the_atoms(monkeypatch):
    real = driver.density_locality_tiles

    def tiles(forest, pts, positions, charges, *a, **k):
        return real(forest, pts, positions[::2], charges[::2], *a, **k)
    monkeypatch.setattr(driver, "density_locality_tiles", tiles)


def _altered(monkeypatch):
    real = driver.Simulation._log_solve

    def log_solve(self, b, x, *a, **k):
        x = np.array(x, np.float64)
        x[len(x) // 3] += 0.1 * np.abs(x).max()
        return real(self, b, x, *a, **k)
    monkeypatch.setattr(driver.Simulation, "_log_solve", log_solve)


@pytest.mark.parametrize("fault", [_unchanged, _half_the_atoms, _altered])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    cell = cells.find_cell(TINY, tiny_root)
    result, checks = run.run_cell(cell, 424242424242, 0.1, False,
                                  device="cpu")
    assert not result["correct"]
    assert checks["residual_max"]["value"] > checks["residual_max"]["limit"]
