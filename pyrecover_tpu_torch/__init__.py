"""pyrecover_tpu_torch: the PyTorch / NVIDIA H100 port of pyrecover_tpu.

The JAX package (``pyrecover_tpu``) is the reference; this package keeps its
module names, its parameter layout (weights ``(in, out)`` applied as
``x @ W``, layers stacked on axis 0) and its numerics, and runs on a CUDA
device through hand-written Hopper kernels where the JAX package had Pallas
kernels (``ops/flash_attention.py``). It imports neither JAX nor the JAX
package.
"""

from pyrecover_tpu_torch.version import __version__

__all__ = ["__version__"]
