"""Plain reference of the charge density at the load's quadrature points.

    rho(x) = 4 pi / (r_c^3 pi^1.5) sum_a q_a exp(-|x - X_a|^2 / r_c^2)

under the locality cut of the published study ("Flag for RHS evaluation
optimization"): a cell sums the atoms that are members of its level-0
ancestor, those within ``cut`` (``nonzero_radius * r_c``) of any vertex of
that base cell, strictly.  A refined cell keeps its ancestor's members, as
the reference attaches atoms to a cell and hands them to its children.
"""

from __future__ import annotations

import math

import torch

ELEMENTS = {"cpu": 1 << 23, "cuda": 1 << 26}   # float64 temporaries a block


def scale(r_c: float) -> float:
    return 4.0 * math.pi / (r_c ** 3 * math.pi ** 1.5)


def member_table(reps: int, lower: float, h0: float, pos: torch.Tensor,
                 cut: float):
    """Members of every base cell as a CSR: ``(ptr (reps^3 + 1,), atom
    ids)``, base cell ``(i, j, k)`` at ``(i * reps + j) * reps + k``.
    Each atom is tested against the base cells of a window around it that
    holds every cell it can be a member of."""
    dev = pos.device
    A = pos.shape[0]
    w = int(math.ceil(cut / h0)) + 2
    r = torch.arange(-w, w + 1, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    home = torch.floor((pos - lower) / h0).to(torch.int64)
    step = max(1, ELEMENTS[dev.type] // (4 * offs.shape[0]))
    keys = []
    for s in range(0, A, step):
        cells = home[s:s + step, None, :] + offs[None]        # (a, W, 3)
        inside = ((cells >= 0) & (cells < reps)).all(-1)
        d = pos[s:s + step, None, :] - (lower + h0 * cells.to(torch.float64))
        e = d - h0
        near = torch.minimum(d * d, e * e).sum(-1) < cut * cut
        a, o = torch.nonzero(inside & near, as_tuple=True)
        c = cells[a, o]
        base = (c[:, 0] * reps + c[:, 1]) * reps + c[:, 2]
        keys.append(base * A + (a + s))
    keys = torch.sort(torch.cat(keys)).values if keys else torch.zeros(
        0, dtype=torch.int64, device=dev)
    counts = torch.bincount(keys // A, minlength=reps ** 3)
    ptr = torch.zeros(reps ** 3 + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr, keys % A


def base_index(mesh) -> torch.Tensor:
    """The base cell of every active cell."""
    anc = mesh.ijk >> mesh.level[:, None]
    return (anc[:, 0] * mesh.reps + anc[:, 1]) * mesh.reps + anc[:, 2]


def density_at(mesh, members, pos: torch.Tensor, q: torch.Tensor,
               r_c: float, dtype=torch.float64) -> torch.Tensor:
    """(C, 8) density at the mesh's load points in ``dtype``."""
    dev = mesh.device
    pos_d, q_d = pos.to(dtype), q.to(dtype)
    xq = mesh.quad_points().to(dtype)
    C = mesh.n_cells
    out = torch.zeros(C, xq.shape[1], dtype=dtype, device=dev)
    inv = 1.0 / (r_c * r_c)
    ptr, atom = members
    if atom.numel() == 0:
        return out
    base = base_index(mesh)
    start = ptr[base]
    count = ptr[base + 1] - start
    K = max(int(count.max()), 1)
    step = max(1, ELEMENTS[dev.type] // (8 * 3 * K))
    ks = torch.arange(K, device=dev)
    for s in range(0, C, step):
        valid = ks[None, :] < count[s:s + step, None]
        idx = torch.where(valid, start[s:s + step, None] + ks[None, :], 0)
        a = atom[idx]
        qa = torch.where(valid, q_d[a], 0.0)
        d = xq[s:s + step, :, None, :] - pos_d[a][:, None, :, :]
        out[s:s + step] = (torch.exp(-(d * d).sum(-1) * inv)
                           * qa[:, None, :]).sum(-1)
    return out * scale(r_c)
