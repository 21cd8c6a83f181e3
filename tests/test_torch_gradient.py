"""Exact-solution gradient of the PyTorch port (ops/gradient.py, plain
version on the CPU) against the JAX package: float64 against
``analytic_solution_gradient`` (rel 1e-12); float32 against the Pallas
kernel ``exact_gradient_pallas(..., interpret=True)`` at the tolerances of
tests/test_kernels.py:196 (rtol 2e-3, atol 2e-4, which the TPU kernel's
Abramowitz-Stegun erf and cross-term r^2 need); the zero at an atom; the
float32 sweep behind the kernel's far path."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_gmg_tpu.models.problems import analytic_solution_gradient
from coulomb_gmg_tpu.ops.pallas_gradient import exact_gradient_pallas
from coulomb_gmg_tpu_torch.models import problems as T
from coulomb_gmg_tpu_torch.ops import gradient as gr
from coulomb_gmg_tpu_torch.ops.density import pack_atoms
from torch_parity import R_C, rel_err, t64

torch.set_num_threads(2)


def _case(seed=6, P=300, A=41):
    """The inputs of tests/test_kernels.py:183."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (P, 3))
    pos = rng.uniform(-1, 1, (A, 3))
    q = rng.choice([-1.0, 1.0], A)
    return pts, pos, q


def _jax_grad(pts, pos, q, r_c=R_C):
    return np.asarray(analytic_solution_gradient(
        jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(q), r_c))


@pytest.mark.parametrize("seed, P, A", [(6, 300, 41), (7, 2000, 300)])
def test_plain_float64_matches_jax(seed, P, A):
    pts, pos, q = _case(seed, P, A)
    out = gr.exact_gradient_plain(t64(pts), pack_atoms(pos, q, "cpu",
                                                       torch.float64), R_C)
    assert out.dtype == torch.float64 and out.shape == (P, 3)
    assert rel_err(out.numpy(), _jax_grad(pts, pos, q)) < 1e-12


def test_problems_gradient_matches_jax():
    pts, pos, q = _case(8)
    pts = np.vstack([pts, pos[:2]])           # two points ON atoms
    out = T.analytic_solution_gradient(t64(pts), t64(pos), t64(q), R_C)
    assert rel_err(out.numpy(), _jax_grad(pts, pos, q)) < 1e-12


def test_plain_float32_matches_pallas_interpret():
    pts, pos, q = _case()
    ref = np.asarray(exact_gradient_pallas(pts, pos, q, R_C, p_tile=128,
                                           a_tile=128, interpret=True))
    out = gr.exact_gradient(torch.from_numpy(pts.astype(np.float32)),
                            pack_atoms(pos, q, "cpu"), R_C)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-4)


def test_zero_at_atom_position():
    """On an atom only the other atoms contribute (include/step_50.h:
    355-369), as the JAX reference and the Pallas kernel's guard give."""
    pos = np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
    q = np.array([1.0, -1.0])
    pts = np.array([[0.5, 0.5, 0.5]])
    ref = _jax_grad(pts, pos, q, 0.4)
    for dt in (torch.float64, torch.float32):
        g = gr.exact_gradient_plain(t64(pts).to(dt),
                                    pack_atoms(pos, q, "cpu", dt), 0.4)
        assert torch.isfinite(g).all()
        only_other = gr.exact_gradient_plain(
            t64(pts).to(dt), pack_atoms(pos[1:], q[1:], "cpu", dt), 0.4)
        assert torch.equal(g, only_other)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("r_c", [R_C, 0.3])
def test_far_bracket_is_exactly_minus_one(r_c):
    """Every float32 ``rq = r / r_c`` in ``[FAR, 1e4]`` gives the bracket
    ``c2 r exp(-rq^2) - erf(rq)`` exactly -1, whether the product and the
    subtraction round separately or as one FMA; past 1e4 the exponential
    is 0.  That is what lets the kernel's far path use ``-q / r^3``."""
    c2 = 2.0 / (np.sqrt(np.pi) * r_c)
    lo, hi = (int(np.float32(v).view(np.int32)) for v in (gr.FAR, 1e4))
    step = 1 << 22
    for s in range(lo, hi + 1, step):
        rq = torch.arange(s, min(s + step, hi + 1),
                          dtype=torch.int32).view(torch.float32)
        c2r = c2 * (rq * r_c)
        e = torch.exp(-rq * rq)
        erf = torch.special.erf(rq)
        assert bool((erf == 1).all())
        assert bool((c2r * e - erf == -1).all())
        fused = c2r.double() * e.double() - erf.double()
        assert bool((fused.float() == -1).all())
    assert float(torch.exp(-torch.tensor(1e4, dtype=torch.float32) ** 2)) == 0
    r = np.float32(gr.FAR * r_c)       # the test the kernel makes
    assert np.float32(gr.far_r2(r_c)) > r * r


def test_cpu_dispatch_is_plain_and_cuda_path_never_falls_back():
    pts, pos, q = _case()
    p32 = torch.from_numpy(pts.astype(np.float32))
    atoms = pack_atoms(pos, q, "cpu")
    before = gr.exact_gradient.launches
    assert torch.equal(gr.exact_gradient(p32, atoms, R_C),
                       gr.exact_gradient_plain(p32, atoms, R_C))
    assert gr.exact_gradient.launches == before
    with pytest.raises(ValueError):
        gr.exact_gradient_cuda(p32, atoms, R_C)
