"""Energy postprocess of the PyTorch port (postprocess/energy.py) against
the JAX package: point location, point values and the electrostatic energy
split on a refined forest with hanging nodes (1e-12), and the FE error in
the energy norm on the problem of tests/test_kernels.py:216, float64 to
rel 1e-10 and float32 to rel 5e-4 (that test's f32-vs-f64 bound)."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.mesh.forest import Forest
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.postprocess import energy as J
from coulomb_gmg_tpu_torch.postprocess import energy as T
from torch_parity import adaptive_forest

torch.set_num_threads(2)


def _refined_case(seed=3):
    f = adaptive_forest(3, reps=4, cycles=1, seed=seed)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(f.dofs_of(1).n_dofs)
    pos = rng.uniform(0.05, 0.95, (23, 3))
    q = rng.choice([-1.0, 1.0], 23)
    return f, u, pos, q


def test_locate_cells_and_point_values_on_hanging_mesh():
    f, u, pos, _ = _refined_case()
    assert len(np.unique(f.level)) == 2
    pts = np.vstack([pos, f.cell_lower()[:5]])    # corners: ties resolved
    np.testing.assert_array_equal(T.locate_cells(f, pts),
                                  J.locate_cells(f, pts))
    np.testing.assert_allclose(T.point_values(f, u, pts),
                               J.point_values(f, u, pts), rtol=1e-12,
                               atol=1e-12)


def test_electrostatic_energy_split():
    f, u, pos, q = _refined_case(4)
    ref = J.electrostatic_energy(f, u, pos, q, 0.5)
    out = T.electrostatic_energy(f, u, pos, q, 0.5)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert abs(out[k] - v) <= 1e-12 * max(abs(v), 1.0), k


def _enorm_case():
    f = Forest.uniform(3, 6, np.zeros(3), 0.3)
    tab = element_tables(3, 1, 2)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.4, 1.4, (29, 3))
    q = rng.choice([-1.0, 1.0], 29)
    u = rng.standard_normal(f.dofs_of(1).n_dofs) * 0.01
    return f, tab, u, pos, q


@pytest.mark.parametrize("dtype, chunk", [(torch.float64, 1 << 18),
                                          (torch.float64, 50),
                                          (torch.float32, 1 << 18)])
def test_energy_norm_error_matches_jax(dtype, chunk):
    f, tab, u, pos, q = _enorm_case()
    if dtype == torch.float64:
        ref, tol = J.energy_norm_error(f, tab, u, pos, q, 0.5), 1e-10
    else:
        ref, tol = J.energy_norm_error(f, tab, u, pos, q, 0.5,
                                       dtype=np.float32), 5e-4
    out = T.energy_norm_error(f, tab, u, pos, q, 0.5, "cpu", dtype=dtype,
                              chunk=chunk)
    assert abs(out - ref) / ref < tol, (out, ref)


def test_energy_norm_error_on_hanging_mesh():
    """float32 (the production path) against float64 on a refined mesh:
    the f32-vs-f64 bound of tests/test_kernels.py:230."""
    f, u, pos, q = _refined_case(5)
    tab = element_tables(3, 1, 2)
    e64 = J.energy_norm_error(f, tab, u * 0.01, pos, q, 0.5)
    e32 = T.energy_norm_error(f, tab, u * 0.01, pos, q, 0.5, "cpu")
    assert abs(e32 - e64) / e64 < 5e-4
