"""PyTorch/CUDA port of the best-effort communication runtime.

A second package beside the JAX reference (``repro``): the numpy modules
are carried over as copies, the vectorized engine is rewritten on torch
tensors, the LM's serving path is rebuilt on ``nn.Module``s and its
training path on the reference's stacked parameter leaves, and the duct
phases, the attention and the gradient compression that ran as Pallas
kernels on the TPU run as hand-written CUDA kernels on the card.  Nothing
here imports ``jax`` or ``repro``.
"""
