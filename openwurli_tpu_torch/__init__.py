"""OpenWurli in PyTorch — the Wurlitzer 200A model for one NVIDIA H100.

A port of the JAX/Pallas package `openwurli_tpu`, which stays beside it as
the reference. Host-side packing (note tables, circuit matrices, DC
operating points) runs in float64 NumPy on the CPU; only the packed float32
arrays move to the device, where two CUDA kernels written for Hopper render
the voice bank and the mono analog chain (`kernels/`, sources in `csrc/`).

Importing this package touches no GPU, compiles nothing and changes no
global setting: the kernels are built by `_build.py` on their first CUDA
call. It never imports `jax` or `openwurli_tpu`.
"""

import os

__version__ = "0.1.0"

# The package's own data files (MLP weights, settled tremolo states): byte
# for byte copies of the reference package's, so the port stands alone.
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
