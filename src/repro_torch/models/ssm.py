"""Mamba (the selective SSM), jamba's sequence mixer: the whole-sequence
forward (prefill) and the O(1)-state decode step.  The counterpart of the
Mamba half of src/repro/models/ssm.py (mLSTM and sLSTM come with xLSTM).

The reference's forward runs a chunked associative scan in jnp and never
calls its Pallas kernel; here the recurrence goes through ``mamba_scan``,
which on a CUDA tensor is the hand-written CUDA kernel and on a CPU tensor
its plain torch version (the reference oracle's sequential recurrence), so
the JAX model is the oracle (the two scans differ by float32 ulps, ROADMAP
Queue 3).  As in the reference, the scan runs in float32 and the
projections in the compute dtype; decode is plain torch.  The functions
take the reference's leaf dicts ({"in_proj", "conv_w", ...}), as
``attention_forward`` does; the ``Mamba`` module holds one layer's leaves.
The reference's sharding constraints are no-ops on one device and are
left out.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models import layers


def _mamba_dims(cfg):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    dt_rank = max(1, math.ceil(d / 16))
    return d, di, cfg.mamba_d_state, cfg.mamba_d_conv, dt_rank


class Mamba(nn.Module):
    """The weights of one Mamba mixer under the reference's leaf names and
    with its initial distributions, applied by ``mamba_forward`` (prefill)
    and ``decode``.  ``dt_bias``, ``A_log`` and ``D`` are float32 whatever
    ``dtype`` is, as in the reference."""

    def __init__(self, gen: torch.Generator, cfg, dtype):
        super().__init__()
        d, di, N, dconv, dt_rank = _mamba_dims(cfg)
        dev = gen.device
        f32 = torch.float32
        self.cfg = cfg
        self.in_proj = layers.param(layers.dense_init(gen, d, 2 * di, dtype))
        self.conv_w = layers.param(
            (torch.randn((dconv, di), generator=gen, device=dev)
             * dconv ** -0.5).to(dtype))
        self.conv_b = layers.zeros(di, dtype, dev)
        self.x_proj = layers.param(
            layers.dense_init(gen, di, dt_rank + 2 * N, dtype))
        self.dt_proj = layers.param(
            layers.dense_init(gen, dt_rank, di, dtype, scale=dt_rank ** -0.5))
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand((di,), generator=gen, device=dev) * (hi - lo) + lo
        self.dt_bias = layers.param(torch.log(torch.expm1(torch.exp(u))))
        A = torch.arange(1, N + 1, dtype=f32, device=dev).repeat(di, 1)
        self.A_log = layers.param(torch.log(A))
        self.D = layers.param(torch.ones((di,), dtype=f32, device=dev))
        self.out_proj = layers.param(layers.dense_init(gen, di, d, dtype))

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        return mamba_decode(self._parameters, x, state, self.cfg)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, di); w: (taps, di).  The taps are
    added one at a time in x's dtype, as the reference's ``sum`` does."""
    taps, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, taps - 1, 0))
    y = pad[:, :S] * w[0]
    for i in range(1, taps):
        y = y + pad[:, i:i + S] * w[i]
    return y + b


def _ssm_params(p, x: torch.Tensor, cfg, compute_dtype):
    """The projections of the conv output x (B, S, di): dt (B, S, di), B
    and C (B, S, N), all float32."""
    _, di, N, _, dt_rank = _mamba_dims(cfg)
    proj = (x @ p["x_proj"].to(compute_dtype)).float()
    dt, Bm, Cm = proj.split([dt_rank, N, N], dim=-1)
    dt = dt @ p["dt_proj"].float() + p["dt_bias"].float()
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt, torch.zeros((), device=dt.device))
    return dt, Bm, Cm


def mamba_scan_inputs(p, x: torch.Tensor, cfg):
    """Everything of the forward before the scan.  x: (B, S, d) ->
    (xin, z, xc, dt, B, C, A): the pre-conv input xin and the gate z
    (B, S, di) in x's dtype, the conv output xc (B, S, di) in x's dtype,
    dt (B, S, di), B and C (B, S, N) float32, and A = -exp(A_log) (di, N),
    computed in A_log's dtype (bf16 once cast, as in the reference) and
    then widened to float32."""
    cd = x.dtype
    xz = x @ p["in_proj"].to(cd)
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    dt, Bm, Cm = _ssm_params(p, xc, cfg, cd)
    A = (-torch.exp(p["A_log"])).float()
    return xin, z, xc, dt, Bm, Cm, A


def mamba_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d), the selective scan through
    ``mamba_scan``.  With ``return_state`` also the decode state: {"h":
    the scan's final state (B, di, N) float32, "conv": the last
    ``d_conv - 1`` pre-conv inputs (B, d_conv - 1, di) in x's dtype}.  Any
    S: where S < d_conv - 1 the conv state is zero-padded in front (the
    reference requires S >= d_conv - 1)."""
    S = x.shape[1]
    _, _, _, dconv, _ = _mamba_dims(cfg)
    cd = x.dtype
    xin, z, xc, dt, Bm, Cm, A = mamba_scan_inputs(p, x, cfg)
    xf = xc.float()
    y, h = mamba_scan(xf, dt, Bm, Cm, A)
    y = y + p["D"].float() * xf
    out = (y.to(cd) * F.silu(z)) @ p["out_proj"].to(cd)
    if not return_state:
        return out
    tail = F.pad(xin, (0, 0, max(0, dconv - 1 - S), 0))[:, -(dconv - 1):]
    return out, {"h": h, "conv": tail.contiguous()}


def mamba_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg) -> torch.Tensor:
    """Single-token step.  x: (B, 1, d); state {"h": (B, di, N) float32,
    "conv": (B, d_conv - 1, di)}, both updated IN PLACE (the reference
    returns a new state).  The conv is one product over the window,
    summed in float32 and rounded once, as the reference's einsum is (its
    prefill adds the taps in the compute dtype instead)."""
    cd = x.dtype
    xin, z = (x @ p["in_proj"].to(cd)).chunk(2, dim=-1)
    window = torch.cat([state["conv"].to(cd), xin], dim=1)  # (B, dconv, di)
    conv = (window.float() * p["conv_w"].to(cd).float()).sum(1).to(cd)
    xc = F.silu(conv + p["conv_b"].to(cd))[:, None]
    state["conv"].copy_(window[:, 1:])
    dt, Bm, Cm = _ssm_params(p, xc, cfg, cd)
    A = (-torch.exp(p["A_log"])).float()
    xf = xc.float()
    dA = torch.exp(dt[..., None] * A)[:, 0]                  # (B, di, N)
    dBx = ((dt * xf)[..., None] * Bm[:, :, None, :])[:, 0]
    h = dA * state["h"] + dBx
    state["h"].copy_(h)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None] \
        + p["D"].float() * xf
    return (y.to(cd) * F.silu(z)) @ p["out_proj"].to(cd)


def init_mamba_state(cfg, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    _, di, N, dconv, _ = _mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, dconv - 1, di), dtype=dtype,
                                device=device)}
