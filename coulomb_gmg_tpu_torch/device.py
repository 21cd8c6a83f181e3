"""Device and precision policy of the PyTorch port.

Counterpart of coulomb_gmg_tpu/utils/platform.py.  The entry points run on
the card unless the caller asks for the CPU, and a CUDA device that is not
there is an error, not a silent fall back to the CPU.  Float32 work runs
with TF32 off, the Hopper analogue of the TPU's bf16 matmul default that
cost 4.6e-3 of true residual in the JAX solve.
"""

from __future__ import annotations

import torch


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
