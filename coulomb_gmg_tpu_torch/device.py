"""Device and precision policy of the PyTorch port.

Counterpart of coulomb_gmg_tpu/utils/platform.py.  The entry points run on
the card unless the caller asks for the CPU, and a CUDA device that is not
there is an error, not a silent fall back to the CPU.  Float32 work runs
with TF32 off, the Hopper analogue of the TPU's bf16 matmul default that
cost 4.6e-3 of true residual in the JAX solve.  Host arrays reach a
device through :func:`upload`, and a matrix's pattern or values come back
from it for a host build through :func:`read_back`; both count them.
"""

from __future__ import annotations

import numpy as np
import torch

from coulomb_gmg_tpu_torch.utils.timer import count


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("coulomb_gmg_tpu_torch: no CUDA device is "
                           "available (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def set_precision() -> None:
    """Full float32 products: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device) -> torch.device:
    """An explicit device ("cpu", "cuda", "cuda:0" or a torch.device);
    a CUDA request checks that the card is there."""
    if device is None:
        raise TypeError("an explicit device is required (e.g. 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    set_precision()
    return dev


def upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """``torch.from_numpy(a).to(device, dtype)``, counted: one to the open
    run's ``uploads`` and ``a.nbytes`` to its ``upload_bytes``
    (utils/timer.py), a CPU destination standing for the card."""
    t = torch.from_numpy(a)
    out = t.to(device) if dtype is None else t.to(device, dtype)
    count("uploads")
    count("upload_bytes", a.nbytes)
    return out


def to_host(a) -> np.ndarray:
    """numpy of a tensor: a CPU tensor's own memory, a card tensor through
    one copy into pinned host memory.  numpy passes through."""
    if not isinstance(a, torch.Tensor):
        return a
    if a.device.type == "cpu":
        return a.numpy()
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    out.copy_(a)
    return out.numpy()


def read_back(t: torch.Tensor) -> np.ndarray:
    """:func:`to_host` of a matrix's pattern or values ``t`` for a build on
    the host, counted: one to the open run's ``readbacks`` and ``t``'s
    bytes to its ``readback_bytes``, a CPU tensor standing for the
    card's."""
    count("readbacks")
    count("readback_bytes", t.numel() * t.element_size())
    return to_host(t)
