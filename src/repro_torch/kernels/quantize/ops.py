"""Blockwise symmetric int8 quantization: dispatch, plain torch versions
and the flat padding/blocking wrappers.

The counterpart of src/repro/kernels/quantize/{ops,ref}.py.  A CUDA tensor
goes through the hand-written kernels (``kernel.py``), a CPU tensor through
``quantize_torch`` / ``dequantize_torch``.  Both compute what the
reference computes under ``jit`` on XLA:CPU, rounding for rounding:

- ``scale = fma(max|x|, fl(1/127), 1e-12)``: XLA turns the ``/ 127.0``
  into a multiply by the float32 reciprocal and fuses the ``+ 1e-12``;
- ``q = clip(rint(x / scale), -127, 127)`` with IEEE division;
- the compressor's residual ``x - q * scale`` is ``fma(-q, scale, x)``;
- its pod sum of ``q * scale`` is ``acc = fma(q_p, scale_p, acc)``, pod
  by pod (``dequantize_torch(..., out=acc)``).

torch has no float32 fma, so ``fma32`` computes one exactly in float64.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import device_kind

#: fl(1/127): the reciprocal XLA multiplies by
RECIP_127 = torch.tensor(1.0, dtype=torch.float32) / 127.0
EPS = 1e-12


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, for float32 operands.

    The product is exact in float64 (24 + 24 bits).  The float64 sum
    ``s`` is rounded, and rounding it again to float32 errs only where
    ``s`` is exactly halfway between two float32 values while the exact
    sum is not; the exact error of the float64 sum (TwoSum) settles that
    case."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)       # s + err == p + c exactly
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward)     # the float32 on s's other side
    mid = (s != rd) & ((s - rd) * 2 == other.double() - rd)
    fix = mid & (err != 0) & ((err > 0) == (s > rd))
    return torch.where(fix, other, r)


def quantize_torch(x: torch.Tensor, *, residual: bool = False):
    """Plain version.  x: (nb, block) -> (q int8 (nb, block), scale
    float32 (nb, 1)) and, when asked, the residual ``fma(-q, scale, x)``
    in x's dtype."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = fma32(m, RECIP_127.to(x.device).expand_as(m),
                  torch.full_like(m, EPS))
    t = torch.round(xf / scale).clamp_(-127, 127)
    q = t.to(torch.int8)
    if not residual:
        return q, scale
    return q, scale, fma32(-t, scale.expand_as(t), xf).to(x.dtype)


def dequantize_torch(q: torch.Tensor, scale: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``q * scale`` in float32, or ``fma(q, scale, out)``
    written into ``out``."""
    qf = q.float()
    if out is None:
        return qf * scale
    out.copy_(fma32(qf, scale.expand_as(qf), out))
    return out


def quantize_blocks(x: torch.Tensor, *, residual: bool = False):
    """The kernel's contract, x: (nb, block) -> (q, scale[, residual]),
    dispatched on x's device: the plain torch version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if device_kind(x, "quantize") == "cpu":
        return quantize_torch(x, residual=residual)
    from repro_torch.kernels.quantize.kernel import quantize_cuda
    return quantize_cuda(x.contiguous(), residual=residual)


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * scale`` (or ``fma(q, scale, out)`` into ``out``), dispatched
    on q's device."""
    if device_kind(q, "dequantize") == "cpu":
        return dequantize_torch(q, scale, out)
    from repro_torch.kernels.quantize.kernel import dequantize_cuda
    return dequantize_cuda(q.contiguous(), scale.contiguous(), out)


def quantize(x: torch.Tensor, *, block: int = 1024):
    """Arbitrary tensor -> (q (nb, block) int8, scale (nb, 1), orig_size):
    flattened and zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    padded = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    q, scale = quantize_blocks(padded)
    return q, scale, flat.numel()


def dequantize(q: torch.Tensor, scale: torch.Tensor, orig_size: int,
               shape=None) -> torch.Tensor:
    flat = dequantize_blocks(q, scale).reshape(-1)[:orig_size]
    return flat.reshape(shape) if shape is not None else flat
