"""coulomb_gmg_tpu_torch — the PyTorch/CUDA port of coulomb_gmg_tpu for one
NVIDIA H100.

The JAX package stays the reference.  This package runs its production
adaptive cycle (``config.py:production_scaling_config``, device-operator
mode) with PyTorch tensors on an explicit device, and carries the two
Pallas kernels of that path as hand-written CUDA C++ for ``sm_90a``
(``csrc/``): the tile density and the ELL SpMV.  Mesh, DoF and constraint
topology comes from the framework-neutral host modules of
``coulomb_gmg_tpu``; nothing here imports jax.
"""

__version__ = "0.1.0"
