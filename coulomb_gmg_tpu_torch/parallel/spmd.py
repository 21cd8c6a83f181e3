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
  no atomics, so every sum is the same from run to run.  In one process
  they are copies and index gathers on the shards' cards, with no read
  from the host and no copy from it (the import index sets are made
  before any capture), peer copies between cards that can read each
  other's memory, so the stepped sharded solves capture them into CUDA
  graphs (:meth:`SpmdContext.graph_mode`);
* across processes (``group``, a ``torch.distributed`` process group of W
  ranks; JAX's multi-process mesh, tests/test_multihost.py): rank r owns
  the D / W shards ``[r D / W, (r + 1) D / W)`` (``shards``), ``devices``
  names only those, and every per-shard list of the solvers holds only
  them.  ``psum`` gathers all D partials in shard order on every rank and
  folds them as one process does, so every rank holds the same bits, and
  those of the one-process D-shard run (never ``all_reduce``, whose order
  of additions is the backend's).  Under gloo a CUDA tensor is staged
  through host memory: the copies are the transport.  Under NCCL the
  collectives run on the card and write receive buffers kept from call
  to call, so a CUDA graph captures them too.  Only the solvers
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
  transposed tables (:func:`gather_sum`), never a scatter-add.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from coulomb_gmg_tpu_torch.adapt.estimator import (_face_grad_tables,
                                                   build_face_plan)
from coulomb_gmg_tpu_torch.device import resolve
from coulomb_gmg_tpu_torch.mesh.forest import to_host
from coulomb_gmg_tpu_torch.ops import tile_density as td
from coulomb_gmg_tpu_torch.ops.density import compute_density
from coulomb_gmg_tpu_torch.postprocess.energy import (electrostatic_energy,
                                                      energy_norm_error_sq,
                                                      locate_cells,
                                                      point_values)


GATHER_WIDTH = 8      # entries of one target summed per gather_sum round


def no_peer_access(cards: list) -> list:
    """The ordered pairs (a, b) of distinct cards where a cannot read b's
    memory: a copy between them goes through the host and cannot be
    captured."""
    return [(a, b) for a in cards for b in cards
            if a != b and not torch.cuda.can_device_access_peer(a, b)]


def gather_sum(vals: torch.Tensor, pos: np.ndarray,
               n_out: int) -> torch.Tensor:
    """``zeros(n_out).index_add(0, pos, vals)`` as gathers, with the same
    order of additions on every run and device (no atomics).

    The entries are sorted by target (stably); each round sums runs of up
    to ``GATHER_WIDTH`` consecutive entries of one target through a
    (width, n_runs) gather table, until one value per target is left.  A
    target hit by at most ``GATHER_WIDTH`` entries is summed in one
    gather, in entry order; the few hit by many (constraint-expanded
    masters, up to ~200 entries) take a round per factor of
    ``GATHER_WIDTH`` instead of widening every target's table to
    theirs."""
    width = GATHER_WIDTH
    out = vals.new_zeros(n_out)
    if len(pos) == 0:
        return out
    dev = vals.device
    order = np.argsort(np.asarray(pos, np.int64), kind="stable")
    target = np.asarray(pos, np.int64)[order]
    v = vals[torch.from_numpy(order).to(dev)]
    while True:
        first = np.flatnonzero(np.r_[True, target[1:] != target[:-1]])
        counts = np.diff(np.r_[first, len(target)])
        local = np.arange(len(target)) - np.repeat(first, counts)
        starts = local % width == 0          # an entry that opens a run
        run = np.cumsum(starts) - 1
        table = np.full((min(width, int(counts.max())), int(run[-1]) + 1),
                        len(target), np.int64)
        table[local % width, run] = np.arange(len(target))
        v = torch.cat([v, v.new_zeros(1)])[torch.from_numpy(table).to(
            dev)].sum(0)
        target = target[starts]
        if counts.max() <= width:
            break
    out[torch.from_numpy(target).to(dev)] = v
    return out


@dataclass
class CommStats:
    """What this rank's collectives moved across processes, by kind
    ("psum", "gather", "halo", or a caller's tag such as "coarse"): calls,
    bytes sent to other ranks, and host seconds inside the
    ``torch.distributed`` calls, waits for the other ranks included (under
    NCCL the enqueue only).  The staging copies are left out: a copy from
    the card to the host also waits for the rank's queued kernels.  A
    kind that a CUDA graph replay ran has seconds None: the host cannot
    time a collective inside a replay."""

    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        s = self.seconds.get(kind, 0.0)
        self.seconds[kind] = None if s is None else s + seconds

    def replayed(self, calls: dict, nbytes: dict) -> None:
        """The collectives of one graph replay: ``calls`` and ``nbytes``
        by kind, as the capture counted them."""
        for kind, n in calls.items():
            self.calls[kind] = self.calls.get(kind, 0) + n
            self.bytes[kind] = self.bytes.get(kind, 0) + nbytes.get(kind, 0)
            self.seconds[kind] = None


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
        self._buffers = {}

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

    def graph_mode(self):
        """(capture, mode) of the stepped sharded solves (solver/fused.py),
        from the topology alone, never from a failure (a capture that
        fails raises):

        * CUDA graphs when every local shard is on a card: one card of one
          process (every collective a copy on that card); several cards of
          one process that can all read each other's memory (one graph
          over all of them, every copy across cards a peer copy between
          captured events); several processes under NCCL (each rank's
          collectives captured on its stream);
        * uncaptured otherwise, one call a replay, ``mode`` saying why:
          shards on the CPU, or on the CPU and on cards mixed; cards
          without peer access, where a copy goes through the host; gloo,
          which stages every message through host memory."""
        devs = self.unique_devices
        procs = f"{self.W} processes ({self.backend})"
        if self.W > 1 and self.backend != "nccl":
            return False, f"stepped, uncaptured: {procs}"
        if any(d.type != "cuda" for d in devs):
            if len(devs) == 1:
                return (False, "stepped, uncaptured: on the "
                        f"{devs[0].type.upper()}")
            return False, (f"stepped, uncaptured: {len(devs)} devices, not "
                           "all of them cards")
        blocked = no_peer_access(devs)
        if blocked:
            return False, (f"stepped, uncaptured: {len(devs)} cards without "
                           "peer access (" + ", ".join(
                               f"{a} -> {b}" for a, b in blocked) + ")")
        if self.W > 1:
            return True, f"stepped, CUDA graphs: {procs}"
        where = devs[0] if len(devs) == 1 else f"{len(devs)} cards"
        return True, f"stepped, CUDA graphs: {self.D} shards on {where}"

    # ---------------------------------------------------------- collectives

    @property
    def backend(self) -> str:
        """The process group's backend ("nccl", "gloo"); None in one
        process."""
        if self._backend is None and self.group is not None:
            self._backend = torch.distributed.get_backend(self.group)
        return self._backend

    @property
    def comm_device(self) -> torch.device:
        """Where messages to other ranks are assembled: the host under
        gloo (the staging buffers), this rank's card under NCCL."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _buffer(self, shape, dtype, device) -> torch.Tensor:
        """The receive buffer of a collective, made at the first call of
        its shape and kept: a captured collective writes the same memory
        at every replay, and allocates nothing while it is captured (the
        warm-up before a capture calls every collective once).  A result
        read from it is used up before the next collective."""
        key = (tuple(shape), dtype, device)
        if key not in self._buffers:
            self._buffers[key] = torch.empty(shape, dtype=dtype,
                                             device=device)
        return self._buffers[key]

    def _gather_ranks(self, local: torch.Tensor, kind: str) -> list:
        """Every rank's ``local`` (at least 1-D, the same shape on every
        rank), in rank order, on this rank's first shard's device."""
        buf = local.to(self.comm_device).contiguous()
        out = self._buffer((self.W * buf.shape[0], *buf.shape[1:]),
                           buf.dtype, buf.device)
        t0 = time.perf_counter()
        torch.distributed.all_gather_into_tensor(out, buf, group=self.group)
        self.stats.add(kind, buf.numel() * buf.element_size()
                       * (self.W - 1), time.perf_counter() - t0)
        return [o.to(self.devices[0]) for o in out.chunk(self.W)]

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
        out = self._buffer((sum(recv_sizes),), buf.dtype, dev)
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
        plan, cell2dof = plan.host, to_host(cell2dof)   # host gather tables
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

    def assembly_tables(self, plan) -> list:
        """Each shard's share of a card assembly plan (fem/card_assembly.py:
        ``CardPlan``, made with ``rhs``), read from its device once.  Per
        shard, the entries that come from its own cells, in the plan's
        order, so that every CSR slot and every load-vector row gets the
        single-device sum's terms in its order:

        * ``mflat``, ``mw``, ``mpos``: a matrix entry is ``mw`` times the
          shard's element matrices ``.reshape(-1)[mflat]``, summed into slot
          ``mpos``;
        * ``rflat``, ``rw``, ``rpos``: a load-vector entry is ``rw`` times
          ``[its cells' load vectors, its dirty cells' lifted load vectors]``
          flattened at ``rflat``, summed into row ``rpos``;
        * ``dirty``, ``g``: its dirty cells (numbered within the shard) and
          their inhomogeneities, for the lift."""
        D, nb, n_cells = self.D, plan.nb, plan.n_cells
        nb2 = nb * nb
        ex = plan.ex
        host = lambda t: to_host(t).astype(np.int64)
        seg, src = host(plan.seg), host(plan.src)
        rseg, rsrc = host(plan.rhs_seg), host(plan.rhs_src)
        cell, ei, ew = host(ex.cell), host(ex.i), to_host(ex.w)
        cell_off, dirty_idx = host(ex.cell_off), host(ex.dirty_idx)
        g_local = to_host(ex.g_local)
        # the matrix entries: the element entry (c * nb + i) * nb + j and
        # its weight
        flat = src.copy()
        w = np.ones(len(src))
        neg = np.flatnonzero(src < 0)
        a, j = np.divmod(-1 - src[neg], ex.kq)
        c = cell[a]
        b = cell_off[c] + j
        flat[neg] = (dirty_idx[c] * nb + ei[a]) * nb + ei[b]
        w[neg] = ew[a] * ew[b]
        slot = np.repeat(np.arange(len(seg) - 1), np.diff(seg))
        # the load vector's entries: a clean cell's (c, i), or the
        # expansion entry a of the dirty cell cell[a] (r_dirty, -1 for a
        # clean one), lifted
        rslot = np.repeat(np.arange(len(rseg) - 1), np.diff(rseg))
        rneg = np.flatnonzero(rsrc < 0)
        ra = -1 - rsrc[rneg]
        r_cell, r_i = np.divmod(rsrc, nb)
        r_dirty = np.full(len(rsrc), -1)
        r_dirty[rneg] = cell[ra]
        r_cell[rneg] = dirty_idx[cell[ra]]
        r_i[rneg] = ei[ra]
        rw = np.ones(len(rsrc))
        rw[rneg] = ew[ra]
        owner = self.owners(n_cells)
        B = self.block(n_cells)
        m_owner, r_owner = owner[flat // nb2], owner[r_cell]
        dd_owner = owner[dirty_idx]
        dd_first = np.searchsorted(dd_owner, np.arange(D))
        shards = []
        for d in range(D):
            m = m_owner == d
            r = r_owner == d
            n_own = len(self.cells(d, n_cells))
            rflat = np.where(r_dirty[r] < 0, r_cell[r] - d * B,
                             n_own + r_dirty[r] - dd_first[d]) * nb + r_i[r]
            dd = dd_owner == d
            shards.append(dict(
                mflat=flat[m] - d * B * nb2, mw=w[m], mpos=slot[m],
                rflat=rflat, rw=rw[r], rpos=rslot[r],
                dirty=dirty_idx[dd] - d * B, g=g_local[dd]))
        return shards

    def build_assembler(self, plan, tab_lap, tab_rhs, has_coeff: bool,
                        np_dtype=np.float64):
        """Distributed assembly with compress.

        Each shard computes the element stiffness and load tensors of its
        own cells (fem/integrals.py math) and sums the entries of the card
        assembly plan that come from its cells (:meth:`assembly_tables`)
        into full-length partial CSR data and RHS by gather; ``psum`` is
        the ``compress(add)`` of src/step-50.cc:831-832.

        Returns fn(h, coeff_q, rho_q) -> (data (nnz,), rhs (n,)) numpy."""
        self._single_process("build_assembler")
        nnz = plan.pattern.nnz
        n = plan.pattern.n_rows
        n_cells = plan.n_cells
        shards = self.assembly_tables(plan)
        dim = tab_lap.dim

        def run(h, coeff_q, rho_q):
            data_parts, rhs_parts = [], []
            for d, (dev, sh) in enumerate(zip(self.devices, shards)):
                cells = self.cells(d, n_cells)
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
                vals = K.reshape(-1)[i(sh["mflat"])] * t(sh["mw"])
                data_parts.append(gather_sum(vals, sh["mpos"], nnz))
                dc = i(sh["dirty"])
                f_eff = F[dc] - torch.einsum("cij,cj->ci", K[dc], t(sh["g"]))
                rvals = torch.cat([F.reshape(-1), f_eff.reshape(-1)])[
                    i(sh["rflat"])] * t(sh["rw"])
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
