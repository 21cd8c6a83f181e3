"""The locality-cut density on atom tiles
(``ops/tile_density.py:tile_density_cuda``): 12 operations per member
(point, atom) term; the atoms, the points' coordinates and the output.

The terms are the member (point, atom) pairs of the locality cut, each
cell's members found from its level-0 ancestor and the atoms
(gmg_bench/metrics/_roofline.py:member_counts), and the bytes are the
atoms, the quadrature points' coordinates and the output.  The program's
copy (``coulomb_gmg_tpu_torch/roofline.py``) takes the bytes of every
operand, the plan arrays (``blk_ptr``, ``atile``, ``anc``) with them, so a
change of the plan would move the bound; here it does not."""

from gmg_bench.metrics._roofline import (FAR_AWAY, OPS_DENSITY,
                                         bound_s as _bound, member_counts)

MODULE = "coulomb_gmg_tpu_torch.ops.tile_density"
LAUNCHER = "tile_density_cuda"
DEVICE = ("tile_density_kernel",)


def bound_s(args, kw) -> float:
    _, _, _, anc, atoms = args
    n_q = kw["n_q"]
    lower = anc.T
    real = lower.abs().amax(-1) < FAR_AWAY
    X = atoms[:3].T
    live = X.abs().amax(-1) < FAR_AWAY
    members = int(member_counts(lower[real], kw["h0"], X[live],
                                kw["cut2"]).sum())
    n_out = kw["n_out"]
    n_bytes = int(live.sum()) * 16 + (n_out * n_q * 3 + n_out * n_q) * 4
    return _bound(OPS_DENSITY * members * n_q, n_bytes)
