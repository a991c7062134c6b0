"""PyTorch + CUDA port of ``vqattack_tpu`` for an NVIDIA H100.

Same module layout and names as the JAX package, which stays the reference
the port is tested against.  The port imports ``torch``, numpy and the
standard library, and nothing of ``jax`` or ``vqattack_tpu``.  The TPU's
Pallas kernels on the ported path are CUDA C++ sources under ``csrc/``,
compiled with ``nvcc`` at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
