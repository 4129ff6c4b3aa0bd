"""Lossy gradient compression with error feedback — the best-effort "message
drop" operator on the cross-pod gradient path.  The counterpart of
src/repro/optim/compression.py.

Coordinates not selected (top-k) or rounded away (int8) are NOT retried;
the residual folds into error-feedback state.  ``encode`` takes one pod's
leaf in the reference's layout (layer parameters stacked over layers, so
a leaf of the layer stack has one more dim than the layer's weight);
``decode_sum`` takes the payloads with a leading pod dim and adds the pods
in order, p = 0, 1, ....  The shapes follow the reference exactly:

- int8: row-wise over the trailing dim for leaves of two or more dims
  (a stacked (28, 1536, 8960) MLP weight is 43,008 rows of 8960), 1-D
  leaves in zero-padded blocks of ``block``;
- top-k: a leaf of more than two dims is flattened to
  ``(leaf.shape[0], -1)``, so a stacked MLP weight's row is a whole layer
  (13,762,560 entries, k = 137,625); 2-D leaves row by row; 1-D leaves as
  one flat row.

The encode goes through the port's kernels (``quantize_blocks`` with its
residual output, ``topk_compress_blocks``) and so does the int8 decode
(``dequantize_blocks``, accumulating pod by pod as ``fma(q, scale, acc)``,
which is what XLA:CPU computes for the reference's sum): a CUDA leaf
launches the hand-written kernels, a CPU leaf takes their plain versions.
On the CPU both compressors equal the reference's jitted ones bitwise.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.quantize import dequantize_blocks, quantize_blocks
from repro_torch.kernels.topk_compress import topk_compress_blocks


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Magnitude top-k selection; payload = (values, indices)."""

    ratio: float = 0.01

    def k_for(self, size: int) -> int:
        return max(1, int(size * self.ratio))

    def encode(self, leaf: torch.Tensor):
        """Returns ({"values", "indices"}, residual): the k largest |x|
        of each row (float32 values, int32 row-local indices) and the
        leaf with them zeroed, in the leaf's dtype."""
        if leaf.ndim >= 2:
            rows = leaf.reshape(leaf.shape[0], -1) if leaf.ndim > 2 else leaf
        else:
            rows = leaf.reshape(1, -1)
        x = rows.float()
        vals, idx = topk_compress_blocks(x, self.k_for(x.shape[-1]))
        residual = x.clone().scatter_(-1, idx.long(), 0.0)
        residual = residual.reshape(leaf.shape).to(leaf.dtype)
        if leaf.ndim < 2:
            vals, idx = vals[0], idx[0]
        return {"values": vals, "indices": idx}, residual

    def decode_sum(self, gathered, shape, dtype) -> torch.Tensor:
        """gathered: payload with a leading pod dim.  The dense sum of
        every pod's selected values, pod by pod."""
        vals, idx = gathered["values"], gathered["indices"]
        if vals.ndim >= 3:  # (P, R, k) row-wise
            R = vals.shape[1]
            dense = torch.zeros((R, math.prod(shape[1:])),
                                dtype=torch.float32, device=vals.device)
            for p in range(vals.shape[0]):
                dense.scatter_add_(1, idx[p].long(), vals[p].float())
            return dense.reshape(shape).to(dtype)
        dense = torch.zeros((math.prod(shape),), dtype=torch.float32,
                            device=vals.device)
        for p in range(vals.shape[0]):
            dense.index_add_(0, idx[p].long(), vals[p].float())
        return dense.reshape(shape).to(dtype)


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Symmetric int8 quantization: row-wise for ndim >= 2 (shape
    preserving), blockwise for 1-D leaves."""

    block: int = 1024

    def encode(self, leaf: torch.Tensor):
        """Returns ({"q" int8, "scale" float32}, residual in the leaf's
        dtype): q and scale (..., 1) of the leaf's shape for ndim >= 2,
        (nb, block) and (nb, 1) for a 1-D leaf."""
        xf = leaf.float()
        if leaf.ndim >= 2:
            q, scale, res = quantize_blocks(
                xf.reshape(-1, leaf.shape[-1]), residual=True)
            return ({"q": q.reshape(leaf.shape),
                     "scale": scale.reshape(*leaf.shape[:-1], 1)},
                    res.reshape(leaf.shape).to(leaf.dtype))
        flat = xf.reshape(-1)
        pad = (-flat.numel()) % self.block
        padded = torch.nn.functional.pad(flat, (0, pad))
        q, scale, res = quantize_blocks(padded.reshape(-1, self.block),
                                        residual=True)
        residual = res.reshape(-1)[:flat.numel()].reshape(leaf.shape)
        return {"q": q, "scale": scale}, residual.to(leaf.dtype)

    def decode_sum(self, gathered, shape, dtype) -> torch.Tensor:
        """gathered: {"q", "scale"} with a leading pod dim.  The sum of the
        pods' ``q * scale``, pod by pod (``fma(q, scale, acc)``)."""
        q, scale = gathered["q"], gathered["scale"]
        total = None
        for p in range(q.shape[0]):
            qp = q[p].reshape(-1, q.shape[-1])
            sp = scale[p].reshape(-1, 1)
            total = dequantize_blocks(qp, sp, out=total)
        if tuple(q.shape[1:]) == tuple(shape):   # row-wise path
            return total.reshape(shape).to(dtype)
        return total.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def get_compressor(name, **kw):
    if name is None or name == "none":
        return None
    if name == "topk":
        return TopKCompressor(**kw)
    if name == "int8":
        return Int8Compressor(**kw)
    raise ValueError(name)
