"""Blockwise magnitude top-k: dispatch, plain torch version and the flat
padding/blocking wrapper.

The counterpart of src/repro/kernels/topk_compress/{ops,ref}.py.  A CUDA
tensor goes through the hand-written kernel (``kernel.py``), a CPU tensor
through ``topk_compress_torch``.  Both give ``lax.top_k``'s selection and
order: per row the k largest |x|, descending, ties to the lower index (a
stable descending sort).  NaN is out of scope.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import device_kind


def topk_compress_torch(x: torch.Tensor, k: int):
    """Plain version.  x: (nb, block) -> (values (nb, k) in x's dtype,
    block-local indices (nb, k) int32)."""
    _, order = torch.sort(x.float().abs(), dim=-1, descending=True,
                          stable=True)
    idx = order[:, :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def topk_compress_blocks(x: torch.Tensor, k: int):
    """The kernel's contract, x: (nb, block) -> (values, indices),
    dispatched on x's device: the plain torch version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if device_kind(x, "topk_compress") == "cpu":
        return topk_compress_torch(x, k)
    from repro_torch.kernels.topk_compress.kernel import topk_compress_cuda
    return topk_compress_cuda(x.contiguous(), k)


def topk_compress(x: torch.Tensor, *, ratio: float = 0.01,
                  block: int = 1024):
    """Blockwise top-k of an arbitrary tensor.  Returns (values (nb, k),
    global indices (nb, k) int32 into the flattened, zero-padded tensor,
    nb)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    padded = torch.nn.functional.pad(flat, (0, pad))
    nb = padded.numel() // block
    k = max(1, int(block * ratio))
    vals, idx = topk_compress_blocks(padded.reshape(nb, block), k)
    offsets = torch.arange(nb, dtype=torch.int32, device=x.device) * block
    return vals, idx + offsets[:, None], nb
