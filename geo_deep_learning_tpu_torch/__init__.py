"""PyTorch / CUDA port of ``geo_deep_learning_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one stays the reference. This package imports
``torch``, ``numpy`` and the standard library only (``yaml`` lazily, when a
config file is read), and nothing of the JAX package. Its hand-written CUDA
kernels live in ``csrc/`` and are built at first use by ``ops/cuda/_lib.py``.
"""
