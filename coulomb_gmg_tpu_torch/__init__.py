"""coulomb_gmg_tpu_torch — the PyTorch/CUDA port of coulomb_gmg_tpu for one
NVIDIA H100.

The JAX package stays the reference.  This package runs its adaptive
cycle in device-operator mode (``config.py:production_scaling_config``,
and ``.prm`` files of the GaussianCharges problem) with PyTorch tensors on
an explicit device, and carries the four Pallas kernels of the repository
as hand-written CUDA C++ for ``sm_90a`` (``csrc/``): the tile density, the
ELL SpMV, the brute-force density and the exact gradient of the FE-error
postprocess; two more kernels do on the card what the JAX package does on
the host: the CSR assembly's ordered segment sum and the SSOR smoother's
sweep.  Mesh, DoF and constraint
topology is host numpy in the package's own modules (``mesh/``, ``fem/``,
``adapt/transfer.py``, ``ops/q1.py``, ``ops/neighbors.py``, ``utils/``),
copies of the JAX package's framework-neutral ones, and the native host
engine (``csrc/forest_engine.cpp``: the atom lists and the CSR to sliced
ELL conversion) builds into ``build/native/`` at first use.  Nothing here imports jax or ``coulomb_gmg_tpu``.
"""

__version__ = "0.1.0"
