"""Float64 densities of the PyTorch port's host-assembled path
(ops/density.py: ``atom_masks``, ``masks_to_lists``, ``cell_quad_points``
and the mask, list and brute-force branches of ``compute_density``)
against the JAX package on a refined mesh: masks and lists equal,
densities rel 1e-12, on the tensor-product rule (separable form) and on
scattered points (direct form)."""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.ops import density as JD
from coulomb_gmg_tpu.ops.neighbors import atom_lists as jatom_lists
from coulomb_gmg_tpu_torch.ops import density as TD
from coulomb_gmg_tpu_torch.ops.q1 import element_tables
from torch_parity import R_C, adaptive_forest, rel_err

torch.set_num_threads(2)
CUT_S = 0.12              # a cutoff that leaves cells without atoms


@pytest.fixture(scope="module")
def setup():
    f = adaptive_forest(3, reps=5, cycles=1, seed=4)
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.35, 0.65, (40, 3))
    q = rng.choice([-1.0, 1.0], 40)
    return f, pos, q, JD.atom_masks(f, pos, CUT_S)


def test_masks_and_lists_match_jax(setup):
    f, pos, q, jmask = setup
    mask = TD.atom_masks(f, pos, CUT_S, "cpu")
    np.testing.assert_array_equal(mask, jmask)
    assert 0 < mask.sum() < mask.size
    for a, b in zip(TD.masks_to_lists(mask), JD.masks_to_lists(jmask)):
        np.testing.assert_array_equal(a, b)
    tab = element_tables(3, 1, 3)
    np.testing.assert_array_equal(TD.cell_quad_points(f, tab.points),
                                  JD.cell_quad_points(f, tab.points))


@pytest.mark.parametrize("branch", ["mask", "lists", "brute"])
@pytest.mark.parametrize("points", ["tensor", "scattered"])
def test_compute_density_matches_jax(setup, branch, points):
    f, pos, q, jmask = setup
    if points == "tensor":
        pref = element_tables(3, 1, 2).points
    else:
        pref = np.random.default_rng(10).random((5, 3))
    kw = {}
    if branch == "mask":
        kw["mask"] = jmask
    elif branch == "lists":
        kw["lists"], _ = jatom_lists(f, pos, CUT_S)
    ref = JD.compute_density(f, pref, pos, q, R_C, **kw)
    out = TD.compute_density(f, pref, pos, q, R_C, "cpu",
                             pairs_per_chunk=1 << 12, **kw)
    assert out.dtype == torch.float64 and out.shape == ref.shape
    assert rel_err(out.numpy(), ref) < 1e-12
    if branch != "brute":
        empty = ~jmask.any(axis=1)
        assert empty.any() and not out.numpy()[empty].any()
