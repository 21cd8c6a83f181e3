"""The FE-error stage split into its parts, at the 64,000-atom scale.

    python -m coulomb_gmg_tpu_torch.profile_enorm [--atoms 64000]
        [--chunks 224] [--chunk 8192] [--loop-iters 2] [--device cuda|cpu]

Counterpart of ``tools/profile_enorm.py`` and of the in-pipeline half of
``tools/roofline.py``.  Random atoms in [-10, 10]^3 of charge +-1, and a
mesh of ``chunks * chunk`` cells (224 x 8,192 is the 64k mesh's 1.8M
cells) with random DoF values, h = 0.0625 and lower corners in the same
box, as the JAX tool draws them.  It measures, one JSON line each:

1. ``h2d_atoms`` and ``h2d_mesh``: the copy to the device of the atoms
   with the standalone call's points, and of the mesh arrays (pageable
   host memory, as the driver copies them);
2. ``grad_standalone``: the exact-gradient kernel at the production call
   shape (``chunk`` cells x 8 Laplace points = P points, against the
   atoms), 8 calls back to back with one synchronisation;
3. ``enorm_loop``: postprocess/energy.py:enorm_loop, the loop of
   ``energy_norm_error_sq``, over the mesh in ``chunks`` chunks of
   ``chunk`` cells, ``--loop-iters`` times after a warm-up;
4. ``enorm_loop_plain``: the same loop once through
   ``exact_gradient_plain`` (the plain version on the card).

Each line gives seconds, Gpairs/s, and the gradient's bound (roofline.py:
the pairs of these inputs, near ones counted at their cost) with the
share of it.  On the card unless ``--device cpu``; without a card it
raises.  Times on the card come from CUDA events or from the host clock
after a synchronisation.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

R_C = 0.5
BOX = 10.0
STANDALONE_CALLS = 8


def atoms_and_points(n_atoms: int, n_points: int, rng):
    """Host arrays: positions (A, 3), charges (A,), points (P, 3)."""
    pos = rng.uniform(-BOX, BOX, (n_atoms, 3))
    q = rng.choice([-1.0, 1.0], n_atoms)
    return pos, q, rng.uniform(-BOX, BOX, (n_points, 3)).astype(np.float32)


def mesh_arrays(n_cells: int, rng) -> dict:
    """Host arrays of a mesh of ``n_cells`` cells as the loop takes them:
    ``ucell`` (C, 8) DoF values, ``h`` (C,), ``lower`` (C, 3)."""
    return {"ucell": (rng.standard_normal((n_cells, 8)) * 0.01).astype(
                np.float32),
            "h": np.full(n_cells, 0.0625, np.float32),
            "lower": rng.uniform(-BOX, BOX, (n_cells, 3)).astype(np.float32)}


def to_device(arrays: dict, device, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype)
            for k, v in arrays.items()}


def loop_error_sq(mesh: dict, tables, atoms: torch.Tensor, chunk: int,
                  grad_fn) -> torch.Tensor:
    """postprocess/energy.py:enorm_loop over ``mesh`` (device tensors
    ``ucell``, ``h``, ``lower``) with the rule of ``tables``: the squared
    error, a float64 0-dim tensor."""
    from coulomb_gmg_tpu_torch.postprocess.energy import enorm_loop
    dev, dt = mesh["h"].device, mesh["h"].dtype
    put = lambda a, t=dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev,
                                                                        t)
    return enorm_loop(mesh["ucell"], mesh["h"], mesh["lower"],
                      put(tables.dphi), put(tables.points),
                      put(tables.weights, torch.float64), atoms, R_C, chunk,
                      grad_fn)


def loop_bound(mesh: dict, pref: torch.Tensor, atoms: torch.Tensor,
               chunk: int) -> dict:
    """The gradient's bound over every point of the loop, counted a chunk
    at a time (roofline.exact_gradient)."""
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.ops.gradient import far_r2
    ops = n_bytes = 0.0
    for s in range(0, mesh["h"].shape[0], chunk):
        hh = mesh["h"][s:s + chunk]
        pts = (mesh["lower"][s:s + chunk, None, :]
               + hh[:, None, None] * pref).reshape(-1, 3)
        b = roofline.exact_gradient(pts, atoms, far_r2(R_C))
        ops += b["ops"]
        n_bytes += b["bytes"]
    return roofline.bound(ops, n_bytes)


def main(argv=None) -> list:
    """Measure and print each part; returns the JSON records."""
    from coulomb_gmg_tpu_torch import roofline
    from coulomb_gmg_tpu_torch.bench_kernels import (device_name, sample_ms,
                                                     wall_s)
    from coulomb_gmg_tpu_torch.device import resolve
    from coulomb_gmg_tpu_torch.ops.density import pack_atoms
    from coulomb_gmg_tpu_torch.ops.gradient import (exact_gradient,
                                                    exact_gradient_plain,
                                                    far_r2)
    from coulomb_gmg_tpu_torch.ops.q1 import element_tables
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--atoms", type=int, default=64000)
    ap.add_argument("--chunks", type=int, default=224,
                    help="chunks of the loop (224: the 64k mesh)")
    ap.add_argument("--chunk", type=int, default=8192,
                    help="cells a chunk")
    ap.add_argument("--loop-iters", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; cpu on request)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    name = device_name(device)
    rng = np.random.default_rng(0)
    tables = element_tables(3, 1, 2)
    n_q = len(tables.points)
    A, P = args.atoms, args.chunk * n_q
    out = []

    def emit(rec):
        rec["device"] = name
        out.append(rec)
        print(json.dumps(rec), flush=True)

    pos, q, pts_np = atoms_and_points(A, P, rng)
    (atoms, pts), s = wall_s(lambda: (pack_atoms(pos, q, device),
                                      torch.from_numpy(pts_np).to(device)),
                             device)
    mb = (atoms.numel() * 4 + pts_np.nbytes) / 1e6
    emit({"measure": "h2d_atoms", "mb": mb, "s": s, "gb_per_s": mb / s / 1e3})
    host = mesh_arrays(args.chunks * args.chunk, rng)
    mesh, s = wall_s(lambda: to_device(host, device), device)
    mb = sum(v.nbytes for v in host.values()) / 1e6
    emit({"measure": "h2d_mesh", "mb": mb, "s": s, "gb_per_s": mb / s / 1e3})

    def rate(rec, pairs, secs, b):
        rec.update(pairs=pairs, gpairs_per_s=pairs / secs / 1e9,
                   bound_s=b["bound_ms"] * 1e-3, bound_by=b["bound_by"],
                   share=b["bound_ms"] * 1e-3 / secs)
        emit(rec)

    grad = lambda: exact_gradient(pts, atoms, R_C)
    grad()                                            # builds the kernel
    per_call = sample_ms(grad, STANDALONE_CALLS, device) * 1e-3
    rate({"measure": "grad_standalone", "shape": f"P={P} A={A}",
          "calls": STANDALONE_CALLS, "s_per_call": per_call}, P * A,
         per_call, roofline.exact_gradient(pts, atoms, far_r2(R_C)))

    pref = torch.from_numpy(tables.points).to(device, torch.float32)
    b_loop = loop_bound(mesh, pref, atoms, args.chunk)
    pairs = args.chunks * args.chunk * n_q * A
    loop = lambda fn: loop_error_sq(mesh, tables, atoms, args.chunk, fn)
    loop(exact_gradient)                              # warm-up
    times, err = [], None
    for _ in range(args.loop_iters):
        e, s = wall_s(lambda: loop(exact_gradient), device)
        times.append(s)
        err = float(e)
    rate({"measure": "enorm_loop", "n_chunks": args.chunks, "s": times,
          "error_sq": err}, pairs, min(times), b_loop)
    e, s = wall_s(lambda: loop(exact_gradient_plain), device)
    rate({"measure": "enorm_loop_plain", "n_chunks": args.chunks, "s": s,
          "error_sq": float(e), "rel_vs_kernel": abs(float(e) / err - 1)},
         pairs, s, b_loop)
    return out


if __name__ == "__main__":
    main()
