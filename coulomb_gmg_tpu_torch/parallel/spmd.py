"""The SPMD context: the driver's multi-device path.

Counterpart of coulomb_gmg_tpu/parallel/spmd.py, the reference's MPI
domain decomposition (p4est partitions cells by contiguous space-filling
curve ranges, src/step-50.cc:120-122; each rank assembles, evaluates and
estimates its own cells and ``compress()`` add-reduces the rest,
src/step-50.cc:831-832).  The JAX package runs it single-controller, one
process over a 1-D device mesh under ``shard_map``; so does the port, one
process over D shards:

* shard d owns the contiguous canonical-order (tree-DFS SFC) cell block
  ``[d * block, (d + 1) * block)`` (:meth:`SpmdContext.block`,
  :meth:`owners`), and its tensors live on its own ``torch.device``:
  ``devices`` names them (``["cpu"] * D`` in the tests, ``["cuda:0"] * D``
  for D shards on one card, the counterpart of the JAX virtual devices),
  and the default takes one visible CUDA device per shard;
* the collectives are plain functions of the context, behind a small
  interface (:meth:`psum`, :meth:`all_gather`, :meth:`exchange`, and
  parallel/sharded.py:halo_import): ``psum`` adds the per-shard partials
  in shard order on the first shard's device and broadcasts the sum, with
  no atomics, so every sum is the same from run to run;
* across processes (``group``, a ``torch.distributed`` process group of W
  ranks; JAX's multi-process mesh, tests/test_multihost.py): rank r owns
  the D / W shards ``[r D / W, (r + 1) D / W)`` (``shards``), ``devices``
  names only those, and every per-shard list of the solvers holds only
  them.  ``psum`` gathers all D partials in shard order on every rank and
  folds them as one process does, so every rank holds the same bits, and
  those of the one-process D-shard run (never ``all_reduce``, whose order
  of additions is the backend's).  Under gloo a CUDA tensor is staged
  through host memory: the copies are the transport.  Only the solvers
  run across processes (parallel/sharded.py, parallel/sharded_gmg.py):
  the pipeline stages below raise there, as the JAX stages fail
  (coulomb_gmg_tpu/parallel/spmd.py:157 fetches arrays that span other
  processes' devices);
* the stages: the density (the mask, list and all-atom branches per shard,
  plain PyTorch as in the JAX module; the all-atom branch does not call
  the dense-density kernel, JAX's does not call its Pallas twin either),
  the tile-density kernel per shard (:meth:`density_tiles`), the FE error
  (the exact-gradient kernel per shard in float32), the Kelly estimate and
  the assembly, each a per-shard partial and a ``psum``; the energy by
  the shard that owns each atom.  Sums over cells are gathers over
  transposed tables (fem/assembly.py:gather_sum), never a scatter-add.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (_face_grad_tables,
                                                   build_face_plan)
from coulomb_gmg_tpu_torch.device import resolve
from coulomb_gmg_tpu_torch.fem.assembly import gather_sum
from coulomb_gmg_tpu_torch.ops import tile_density as td
from coulomb_gmg_tpu_torch.ops.density import compute_density
from coulomb_gmg_tpu_torch.postprocess.energy import (electrostatic_energy,
                                                      energy_norm_error_sq,
                                                      locate_cells,
                                                      point_values)


@dataclass
class CommStats:
    """What this rank's collectives moved across processes, by kind
    ("psum", "gather", "halo", or a caller's tag such as "coarse"): calls,
    bytes sent to other ranks, and host seconds inside the
    ``torch.distributed`` calls, waits for the other ranks included (under
    NCCL the enqueue only).  The staging copies are left out: a copy from
    the card to the host also waits for the rank's queued kernels."""

    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


class SpmdContext:
    """D shards, their devices, the cell partition and the sharded
    pipeline stages; with a process ``group`` of W ranks, this rank's
    D / W shards."""

    def __init__(self, n_devices: int, devices=None, group=None):
        self.D = int(n_devices)
        self.group = group
        self.W = 1 if group is None else int(group.size())
        self.rank = 0 if group is None else int(group.rank())
        if self.D % self.W:
            raise ValueError(f"{self.D} shards do not split over "
                             f"{self.W} ranks")
        n_local = self.D // self.W
        self.shards = list(range(self.rank * n_local,
                                 (self.rank + 1) * n_local))
        if devices is None:
            if self.W > 1:
                raise ValueError("list this rank's shards' devices, e.g. "
                                 f"['cuda:0'] * {n_local}")
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n < n_devices:
                raise RuntimeError(
                    f"Config.n_devices={n_devices} but only {n} CUDA "
                    f"devices are visible (list the shards' devices, e.g. "
                    f"['cuda:0'] * {n_devices} or ['cpu'] * {n_devices})")
            devices = [f"cuda:{i}" for i in range(n_devices)]
        if len(devices) != n_local:
            raise ValueError(f"{len(devices)} devices for {n_local} "
                             "shards")
        self.devices = [resolve(d) for d in devices]
        self.unique_devices = list(dict.fromkeys(self.devices))
        self.stats = CommStats()
        self._backend = None

    def _single_process(self, stage: str) -> None:
        if self.W > 1:
            raise NotImplementedError(
                f"SpmdContext.{stage} runs in one process only: across "
                f"{self.W} processes only the sharded solvers run (the JAX "
                "pipeline stages fail there too, coulomb_gmg_tpu/parallel/"
                "spmd.py:157)")

    # ------------------------------------------------------ cell partition

    def block(self, n_cells: int) -> int:
        """Cells per shard (the last shard may own fewer real cells)."""
        return (n_cells + self.D - 1) // self.D

    def owners(self, n_cells: int) -> np.ndarray:
        """(n_cells,) owning shard by contiguous canonical-order blocks:
        the subdomain id (p4est SFC partition, src/step-50.cc:120-122)."""
        B = self.block(n_cells)
        return (np.arange(n_cells) // B).astype(np.int32)

    def cells(self, d: int, n_cells: int) -> range:
        """The cells shard ``d`` owns."""
        B = self.block(n_cells)
        return range(min(d * B, n_cells), min((d + 1) * B, n_cells))

    # ---------------------------------------------------------- collectives

    @property
    def comm_device(self) -> torch.device:
        """Where messages to other ranks are assembled: the host under
        gloo (the staging buffers), this rank's card under NCCL."""
        if self._backend is None:
            self._backend = torch.distributed.get_backend(self.group)
        if self._backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _gather_ranks(self, local: torch.Tensor, kind: str) -> list:
        """Every rank's ``local`` (the same shape on every rank), in rank
        order, on this rank's first shard's device."""
        buf = local.to(self.comm_device).contiguous()
        out = [torch.empty_like(buf) for _ in range(self.W)]
        t0 = time.perf_counter()
        torch.distributed.all_gather(out, buf, group=self.group)
        self.stats.add(kind, buf.numel() * buf.element_size()
                       * (self.W - 1), time.perf_counter() - t0)
        return [o.to(self.devices[0]) for o in out]

    def broadcast(self, t: torch.Tensor) -> list:
        """One copy of ``t`` per local shard, on its device (shards that
        share a device share the copy)."""
        copies = {dev: t.to(dev) for dev in self.unique_devices}
        return [copies[dev] for dev in self.devices]

    def psum(self, parts: list) -> list:
        """Sum of the per-shard partials, added in shard order on the first
        shard's device, on every shard (across ranks: all D partials
        gathered first, so every rank folds the same sum)."""
        if self.W > 1:
            local = torch.stack([p.to(self.devices[0]) for p in parts])
            parts = [row for g in self._gather_ranks(local, "psum")
                     for row in g.unbind(0)]
        acc = parts[0].to(self.devices[0])
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        return self.broadcast(acc)

    def all_gather(self, parts: list, kind: str = "gather") -> list:
        """The shards' blocks concatenated in shard order, on every
        shard (across ranks every shard's block must have one shape)."""
        full = torch.cat([p.to(self.devices[0]) for p in parts])
        if self.W > 1:
            full = torch.cat(self._gather_ranks(full, kind))
        return self.broadcast(full)

    def exchange(self, sends: list, recv_sizes: list) -> list:
        """Point-to-point messages between the ranks (the halo imports),
        one ``all_to_all_single``: ``sends[q]`` (1-D) goes to rank q, and
        the result's ``[q]`` is the ``recv_sizes[q]`` values from rank q,
        on this rank's first shard's device.  The message to itself is
        empty."""
        dev = self.comm_device
        buf = torch.cat([s.to(dev) for s in sends])
        out = torch.empty(sum(recv_sizes), dtype=buf.dtype, device=dev)
        t0 = time.perf_counter()
        torch.distributed.all_to_all_single(
            out, buf, output_split_sizes=list(recv_sizes),
            input_split_sizes=[len(s) for s in sends], group=self.group)
        self.stats.add("halo", buf.numel() * buf.element_size(),
                       time.perf_counter() - t0)
        return list(out.to(self.devices[0]).split(list(recv_sizes)))

    # ---------------------------------------------------- sharded density

    def density(self, forest, points_ref, positions, charges, r_c: float,
                mask=None, lists=None, dtype=torch.float64) -> torch.Tensor:
        """Charge density over each shard's own cells (src/step-50.cc:
        509-575 loops the locally owned cells): the mask, list or all-atom
        branch of ops/density.py:compute_density in ``dtype``.  Returns
        (n_cells, n_q) on the first shard's device."""
        self._single_process("density")
        n = forest.n_cells
        parts = [compute_density(forest, points_ref, positions, charges,
                                 r_c, dev, mask=mask, lists=lists,
                                 dtype=dtype, cells=self.cells(d, n))
                 for d, dev in enumerate(self.devices)]
        return self.all_gather(parts)[0]

    def density_tiles(self, forest, points_ref, positions, charges,
                      r_c: float, cutoff: float) -> torch.Tensor:
        """The locality density by the tile kernel, each shard on its own
        contiguous range of the plan's cell blocks (a slice of the CSR
        ``blk_ptr``, its items and its cells), the atoms on every shard.
        A block's output depends on nothing but its own items, so the
        result is bit-identical to the single-device tile density and
        needs no reduction.  Returns (n_cells, n_q) float32 on the first
        shard's device."""
        self._single_process("density_tiles")
        n_q = len(points_ref)
        C = forest.n_cells
        if len(positions) == 0:
            return torch.zeros(C, n_q, dtype=torch.float32,
                               device=self.devices[0])
        plan = td.build_tile_plan(forest, n_q, positions, charges, cutoff)
        args, kw = td.plan_operands(forest, points_ref, plan, r_c, cutoff,
                                    "cpu")
        blk_ptr, atile, _, _, atoms = args
        nbb = (plan.nb + self.D - 1) // self.D
        parts = []
        for d, dev in enumerate(self.devices):
            b0, b1 = min(d * nbb, plan.nb), min((d + 1) * nbb, plan.nb)
            rows = max(min(b1 * plan.cpb, C) - b0 * plan.cpb, 0)
            if rows == 0:
                continue
            i0, i1 = int(blk_ptr[b0]), int(blk_ptr[b1])
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            pts, anc = td.build_geom(
                put(plan.cells[b0 * plan.cpb: b1 * plan.cpb]),
                put(np.asarray(points_ref, np.float32)), float(forest.h0),
                forest.lower)
            parts.append(td.tile_density(
                (blk_ptr[b0: b1 + 1] - i0).to(dev), atile[i0:i1].to(dev),
                pts, anc, atoms.to(dev), n_out=rows, **kw))
        return self.all_gather(parts)[0]

    # ------------------------------------------- sharded energy-norm error

    def energy_norm_error(self, forest, tables, u, positions, charges,
                          r_c: float, dtype=torch.float64) -> float:
        """sqrt(sum_c int ||grad u_h - grad u_exact||^2): each shard's cells
        through postprocess/energy.py (the exact-gradient kernel in
        float32 on the card), the partials summed by ``psum`` (the
        reference's MPI sum, src/step-50.cc:1459)."""
        self._single_process("energy_norm_error")
        n = forest.n_cells
        parts = [energy_norm_error_sq(forest, tables, u, positions, charges,
                                      r_c, dev, dtype=dtype,
                                      cells=self.cells(d, n))
                 for d, dev in enumerate(self.devices)]
        return float(torch.sqrt(self.psum(parts)[0]))

    # --------------------------------------------------- sharded estimator

    def estimate(self, forest, cell2dof, u, plan=None) -> np.ndarray:
        """Kelly face-jump indicators (adapt/estimator.py:estimate without
        the volume term, Q1, float64), sharded: each shard integrates the
        jumps of the faces whose first (fine) cell it owns, sums them per
        cell by gather, and ``psum`` adds the shards' partials
        (src/step-50.cc:1020-1090 estimates locally owned cells per
        rank)."""
        self._single_process("estimate")
        dim = forest.dim
        if cell2dof.shape[1] != 2 ** dim:
            raise ValueError("the sharded estimator is Q1-only")
        if plan is None:
            plan = build_face_plan(forest)
        grads, fweights, sub_grads = _face_grad_tables(dim, 1, 2)
        # the face groups of the host estimator: (a, b, Ga, Gb, w)
        groups = []
        for axis in range(dim):
            sel = plan.sl_axis == axis
            if sel.any():
                f_hi, f_lo = 2 * axis + 1, 2 * axis
                groups.append((plan.sl_a[sel], plan.sl_b[sel],
                               grads[f_hi][:, :, axis],
                               grads[f_lo][:, :, axis], fweights[f_hi]))
        for axis in range(dim):
            for sidev in (0, 1):
                for sub in range(2 ** (dim - 1)):
                    sel = ((plan.cf_axis == axis) & (plan.cf_side == sidev)
                           & (plan.cf_sub == sub))
                    if sel.any():
                        f = 2 * axis + sidev
                        groups.append((plan.cf_fine[sel],
                                       plan.cf_coarse[sel],
                                       grads[f][:, :, axis],
                                       sub_grads[(f, sub)][:, :, axis],
                                       fweights[f]))
        n_cells = forest.n_cells
        owner = self.owners(n_cells)
        h = forest.cell_h()
        ucell = np.asarray(u, np.float64)[cell2dof]
        parts = []
        for d, dev in enumerate(self.devices):
            t = lambda a: torch.from_numpy(np.ascontiguousarray(
                a, np.float64)).to(dev)
            uc, hd = t(ucell), t(h)
            diam = hd * np.sqrt(dim)
            vals, pos = [], []
            for a, b, Ga, Gb, w in groups:
                mine = owner[a] == d
                a, b = a[mine], b[mine]
                if not len(a):
                    continue
                ia = torch.from_numpy(a).to(dev)
                ib = torch.from_numpy(b).to(dev)
                ga = (uc[ia] @ t(Ga).T) / hd[ia][:, None]
                gb = (uc[ib] @ t(Gb).T) / hd[ib][:, None]
                Jf = (((ga - gb) ** 2) @ t(w)) * hd[ia] ** (dim - 1)
                vals += [diam[ia] * Jf, diam[ib] * Jf]
                pos += [a, b]
            if not vals:
                parts.append(torch.zeros(n_cells, dtype=torch.float64,
                                         device=dev))
                continue
            parts.append(gather_sum(torch.cat(vals), np.concatenate(pos),
                                      n_cells))
        return np.sqrt(self.psum(parts)[0].cpu().numpy())

    # --------------------------------------------------- sharded assembly

    def build_assembler(self, plan, tab_lap, tab_rhs, has_coeff: bool,
                        np_dtype=np.float64):
        """Distributed assembly with compress.

        Each shard computes the element stiffness and load tensors of its
        own cells (fem/integrals.py math) and sums the entries of the
        assembly plan (fem/assembly.py) that come from its cells into
        full-length partial CSR data and RHS by gather; ``psum`` is the
        ``compress(add)`` of src/step-50.cc:831-832.

        Returns fn(h, coeff_q, rho_q) -> (data (nnz,), rhs (n,)) numpy."""
        self._single_process("build_assembler")
        D = self.D
        nnz = plan.pattern.nnz
        n = plan.pattern.n_rows
        nb = plan.n_basis
        B = self.block(plan.n_cells)
        owner = self.owners(plan.n_cells)
        dtype = torch.float64 if np_dtype == np.float64 else torch.float32
        n_clean = len(plan.clean_idx)
        cl_pos = plan.m_pos[: n_clean * nb * nb].reshape(n_clean, nb * nb)
        cl_rdof = plan.r_dof_clean.reshape(n_clean, nb)
        md_pos = plan.m_pos[n_clean * nb * nb:]
        dd_owner = owner[plan.dirty_idx]
        rd_owner = dd_owner[plan.rd_cell]
        dd_first = np.searchsorted(dd_owner, np.arange(D))

        # per shard: the entries of its cells, cell ids local to its block
        shards = []
        for d in range(D):
            cl = owner[plan.clean_idx] == d
            md = owner[plan.md_cell] == d
            dg = owner[plan.d_cell] == d
            dd = dd_owner == d
            rd = rd_owner == d
            shards.append(dict(
                cl=plan.clean_idx[cl] - d * B,
                md=(plan.md_cell[md] - d * B, plan.md_i[md], plan.md_j[md],
                    plan.md_w[md]),
                dg=(plan.d_cell[dg] - d * B, plan.d_i[dg]),
                mpos=np.concatenate([cl_pos[cl].reshape(-1), md_pos[md],
                                     plan.d_pos[dg]]),
                dd=(plan.dirty_idx[dd] - d * B, plan.gd_local[dd]),
                rd=(plan.rd_cell[rd] - dd_first[d], plan.rd_i[rd],
                    plan.rd_w[rd]),
                rpos=np.concatenate([cl_rdof[cl].reshape(-1),
                                     plan.rd_dof[rd]])))
        dim = tab_lap.dim

        def run(h, coeff_q, rho_q):
            data_parts, rhs_parts = [], []
            for d, (dev, sh) in enumerate(zip(self.devices, shards)):
                cells = self.cells(d, plan.n_cells)
                sl = slice(cells.start, cells.stop)
                t = lambda a: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(a, np_dtype))).to(dev)
                i = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(
                    dev)
                hh = t(np.asarray(h)[sl])
                wl, G = t(tab_lap.weights), t(tab_lap.grad_outer)
                scale = hh ** (dim - 2)
                if has_coeff:
                    K = scale[:, None, None] * torch.tensordot(
                        t(np.asarray(coeff_q)[sl]) * wl[None, :], G,
                        dims=([1], [0]))
                else:
                    K = scale[:, None, None] * torch.einsum(
                        "q,qij->ij", wl, G)[None]
                F = (hh ** dim)[:, None] * (
                    (t(np.asarray(rho_q)[sl]) * t(tab_rhs.weights)[None, :])
                    @ t(tab_rhs.phi))
                mc, mi, mj, mw = sh["md"]
                gc, gi = sh["dg"]
                vals = torch.cat([K[i(sh["cl"])].reshape(-1),
                                  K[i(mc), i(mi), i(mj)] * t(mw),
                                  K[i(gc), i(gi), i(gi)]])
                data_parts.append(gather_sum(vals, sh["mpos"], nnz))
                dc, gd = sh["dd"]
                rc, ri, rw = sh["rd"]
                f_eff = F[i(dc)] - torch.einsum("cij,cj->ci", K[i(dc)],
                                                t(gd))
                rvals = torch.cat([F[i(sh["cl"])].reshape(-1),
                                   f_eff[i(rc), i(ri)] * t(rw)])
                rhs_parts.append(gather_sum(rvals, sh["rpos"], n))
            return (self.psum(data_parts)[0].cpu().numpy(),
                    self.psum(rhs_parts)[0].cpu().numpy())

        return run


def electrostatic_energy_spmd(spmd: SpmdContext, forest, u, positions,
                              charges, r_c: float, degree: int = 1):
    """The energy postprocess with shard-ownership dedup: each atom's
    potential is evaluated by the shard owning the cell that contains it,
    and the atom count is cross-checked (the all_gather and lowest-rank
    dedup of src/step-50.cc:1334-1398)."""
    spmd._single_process("electrostatic_energy_spmd")
    positions = np.asarray(positions)
    atom_owner = spmd.owners(forest.n_cells)[locate_cells(forest, positions)]
    phi = np.zeros(len(charges))
    n_eval = 0
    for d in range(spmd.D):
        sel = atom_owner == d
        if sel.any():
            phi[sel] = point_values(forest, u, positions[sel], degree=degree)
            n_eval += int(sel.sum())
    if n_eval != len(charges):
        raise AssertionError(f"{n_eval} atoms evaluated, {len(charges)} "
                             "expected")
    return electrostatic_energy(forest, u, positions, charges, r_c,
                                degree=degree, phi_at_atoms=phi)
