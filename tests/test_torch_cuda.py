"""The hand CUDA kernels of the PyTorch port against their plain PyTorch
versions, on the card.  Every test here needs a CUDA card and skips without
one; the file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coulomb_gmg_tpu.config import production_scaling_config
from coulomb_gmg_tpu.models.atoms import nacl_lattice
from coulomb_gmg_tpu.ops.q1 import element_tables
from coulomb_gmg_tpu.utils.logging import Pcout
from coulomb_gmg_tpu_torch.driver import Simulation
from coulomb_gmg_tpu_torch.ops import ell, stencil, tile_density as td
from torch_parity import CUT, R_C, adaptive_forest, tile_setup

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_ell_kernel_matches_plain(card, dtype, tol):
    f = adaptive_forest(3)
    ld = f.dofs_of(1).levels[-1]
    t = stencil.level_topology(f, ld, len(f.dofs_of(1).levels) - 1)
    T = torch.from_numpy(stencil.stencil_table(3, element_tables(3, 1, 2)))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    cols, vals, _ = stencil.build_level_ops(
        put(t.coords), put(t.mask8), put(t.elim), put(t.iface),
        put(t.boundary), t.n, T.to(card), dim=3, side=t.side, h=t.h,
        want_iface=False, dtype=dtype)
    x = put(np.random.default_rng(0).standard_normal(t.n)).to(dtype)
    before = ell.ell_mv.launches
    yk = ell.ell_mv(cols, vals, x)
    assert ell.ell_mv.launches == before + 1
    yp = ell.ell_mv_plain(cols, vals, x)
    assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())


@pytest.mark.parametrize("refine_seed", [None, 2])
def test_tile_density_kernel_matches_plain(card, refine_seed):
    f, atoms, tab = tile_setup(2, 2, refine_seed)
    plan = td.build_tile_plan(f, len(tab.points), atoms.positions,
                              atoms.charges, CUT, n_rows=f.n_cells + 1)
    args, kw = td.plan_operands(f, tab.points, plan, R_C, CUT, card)
    before = td.tile_density.launches
    rk = td.tile_density(*args, n_out=f.n_cells + 1, **kw)
    assert td.tile_density.launches == before + 1
    rp = td.tile_density_plain(*args, n_out=f.n_cells + 1, **kw)
    assert torch.equal(rk != 0, rp != 0)
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())


def test_slice_on_card_8_atoms(card):
    cfg = production_scaling_config(1, dtype="float32")
    sim = Simulation(cfg, atoms=nacl_lattice(1), device=card,
                     pcout=Pcout(enabled=False))
    ell.ell_mv.launches = td.tile_density.launches = 0
    res = sim.run()
    assert [r["n_cells"] for r in res] == [85184, 85744, 87648, 91344,
                                           99464]
    assert all(r["residual"] <= 1.01e-8 * r["l2_rhs"] for r in res)
    assert ell.ell_mv.launches > 0 and td.tile_density.launches == 5
