"""reseek_tpu_torch: the reseek-tpu structure search on PyTorch and CUDA.

A port of ``reseek_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, with
hand-written CUDA kernels in ``csrc/``.  It imports the JAX-free host
layer of ``reseek_tpu`` (io, encoder, align, constants, data, the numpy
and native ops) and never imports ``jax``.

Ported so far: the all-vs-all self-search (``search.driver.self_search``,
``python -m reseek_tpu_torch search``).
"""

__version__ = "0.1.0"
