"""coulomb_gmg_tpu_torch — the PyTorch/CUDA port of coulomb_gmg_tpu for one
NVIDIA H100.

The JAX package stays the reference.  This package runs its adaptive
cycle in device-operator mode (``config.py:production_scaling_config``,
and ``.prm`` files of the GaussianCharges problem) with PyTorch tensors on
an explicit device, and carries the four Pallas kernels of the repository
as hand-written CUDA C++ for ``sm_90a`` (``csrc/``): the tile density, the
ELL SpMV, the brute-force density and the exact gradient of the FE-error
postprocess.  Mesh, DoF and constraint
topology comes from the framework-neutral host modules of
``coulomb_gmg_tpu``; nothing here imports jax.
"""

__version__ = "0.1.0"
