"""Process bring-up of the PyTorch port: ``torch.distributed`` for runs
over several processes.

Counterpart of ``init_distributed`` in coulomb_gmg_tpu/utils/platform.py,
the analogue of the reference's ``MPI_InitFinalize`` (src/main.cc:8).  The
arguments default to the environment that ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as the JAX
function reads the JAX conventions.  The device policy stays in
``coulomb_gmg_tpu_torch/device.py``.

The backend is chosen explicitly, never by a fallback:

* ``nccl`` needs every rank on a card of its own (``cuda:LOCAL_RANK``);
  NCCL refuses two ranks on one card, so such a mapping is an error
  (:func:`nccl_device`);
* ``gloo`` takes CPU tensors; for CUDA tensors the port's collectives
  stage each message through host memory themselves
  (parallel/spmd.py:SpmdContext), so two ranks may share one card;
* the default is ``nccl`` when the ranks' tensors are on CUDA and each
  rank has its own card; otherwise the caller names ``gloo``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def world_size() -> int:
    """Ranks in the default group; 1 when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def nccl_device(local_rank: int, n_cards: int) -> torch.device:
    """The card of a rank under NCCL: ``cuda:<local_rank>``.  Raises when
    the host has too few cards, i.e. when two ranks would share one."""
    if local_rank < 0 or local_rank >= n_cards:
        shared = local_rank % n_cards if n_cards > 0 else None
        raise ValueError(
            f"NCCL needs one CUDA card per rank: local rank {local_rank} "
            f"has no card of its own ({n_cards} visible"
            + (f"; it would share cuda:{shared} with local rank {shared}"
               if shared is not None else "")
            + "). Ask for backend='gloo', which stages CUDA tensors through "
              "host memory, to put several ranks on one card")
    return torch.device("cuda", local_rank)


def init_distributed(init_method: str = None, world_size: int = None,
                     rank: int = None, backend: str = None, device=None,
                     local_rank: int = None,
                     timeout_s: float = 300.0) -> torch.device:
    """Join (or create) the default process group; returns this rank's
    device.

    ``init_method`` defaults to ``tcp://MASTER_ADDR:MASTER_PORT``,
    ``world_size``, ``rank`` and ``local_rank`` to ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``, ``device`` to ``cuda:<local_rank>``.  Under NCCL
    the device must be that card.  A missing peer fails the call after
    ``timeout_s`` seconds instead of hanging it.  A no-op (returning the
    device) if the group is already initialized."""
    lr = _env_int("LOCAL_RANK", 0) if local_rank is None else local_rank
    dev = torch.device("cuda", lr) if device is None else torch.device(
        device)
    if backend is None:
        if dev.type != "cuda":
            raise ValueError(f"no default backend for {dev} tensors: ask "
                             "for backend='gloo' by name")
        backend = "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        card = nccl_device(lr, n_cards)
        if dev != card and dev != torch.device("cuda"):
            raise ValueError(f"NCCL puts local rank {lr} on {card}, not on "
                             f"{dev}")
        dev = card
    if dev.type == "cuda":
        from coulomb_gmg_tpu_torch.device import resolve
        dev = resolve(dev)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if init_method is None:
        port = os.environ.get("MASTER_PORT")
        if not port:
            raise ValueError("init_distributed: no init_method and no "
                             "MASTER_PORT in the environment")
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                       f":{port}")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=_env_int("WORLD_SIZE", 1) if world_size is None
        else world_size,
        rank=_env_int("RANK", 0) if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev
