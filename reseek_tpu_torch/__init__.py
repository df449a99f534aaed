"""reseek_tpu_torch: the reseek-tpu structure search on PyTorch and CUDA.

A port of ``reseek_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, with
hand-written CUDA kernels in ``csrc/``.  It stands alone: it keeps its own
copy of the JAX-free host layer (io, encoder, align, constants, data, the
numpy and native ops, the native C++ sources in ``native/``, the host
engine in ``search/host.py``) and imports neither ``jax`` nor
``reseek_tpu``.

Ported so far: the all-vs-all, query-vs-DB and -fast searches
(``search.driver``, ``python -m reseek_tpu_torch search``), on one device,
a mesh of devices, or several processes.
"""

__version__ = "0.1.0"
