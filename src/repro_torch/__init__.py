"""PyTorch/CUDA port of the best-effort communication runtime.

A second package beside the JAX reference (``repro``): the numpy modules
are carried over as copies, the vectorized engine is rewritten on torch
tensors, and the duct phases that ran as Pallas kernels on the TPU run as
hand-written CUDA kernels on the card.  Nothing here imports ``jax`` or
``repro``.
"""
