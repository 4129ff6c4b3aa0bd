"""Sub-quadratic sequence mixers: Mamba (the selective SSM, jamba's
mixer), mLSTM and sLSTM (xLSTM's), each as a whole-sequence forward
(prefill and training) and an O(1)-state decode step.  The counterpart of
src/repro/models/ssm.py.

The reference's forwards run in jnp and never call their Pallas kernels;
here the Mamba recurrence goes through ``mamba_scan`` and the mLSTM's
stabilized parallel mix through ``mlstm_attention``, each on a CUDA tensor
the hand-written CUDA kernel and on a CPU tensor its plain torch version
(the reference oracle's form), so the JAX model is the oracle (the Mamba
scans differ by float32 ulps, ROADMAP Queue 3).  Both are differentiable:
their backwards are hand-written kernels too (``mamba_scan_backward``,
``mlstm_attention_backward``), held to ``jax.grad`` of the reference's jnp
forms.  The sLSTM is a sequential recurrence with no kernel in the
reference (a ``lax.scan``): here a Python loop over the sequence in plain
torch, differentiated by autograd.  As in the reference, the scans, the
mLSTM mix and the sLSTM state run in float32 and the projections in the
compute dtype; decode is plain torch and writes the state in place.  The
forwards build the decode state only when ``return_state`` asks for it
(training never does).  The functions take the reference's leaf dicts
({"in_proj", "conv_w", ...}), as ``attention_forward`` does; the
``Mamba``, ``MLSTM`` and ``SLSTM`` modules hold one layer's leaves.  The
reference's sharding constraints are no-ops on one device and are left
out.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mlstm_attention import mlstm_attention
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
    then widened to float32.  Differentiable: in training A_log arrives
    cast from its float32 master (``lm.cast_leaves``), and the casts pass
    its gradient back to the master, as the reference's do."""
    cd = x.dtype
    xz = x @ p["in_proj"].to(cd)
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    dt, Bm, Cm = _ssm_params(p, xc, cfg, cd)
    A = (-torch.exp(p["A_log"])).float()
    return xin, z, xc, dt, Bm, Cm, A


def mamba_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d), the selective scan through
    ``mamba_scan`` (differentiable).  With ``return_state`` also the
    decode state: {"h": the scan's final state (B, di, N) float32, "conv":
    the last ``d_conv - 1`` pre-conv inputs (B, d_conv - 1, di) in x's
    dtype}.  Any S: where S < d_conv - 1 the conv state is zero-padded in
    front (the reference requires S >= d_conv - 1)."""
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block, stabilized parallel form)
# ---------------------------------------------------------------------------
#: the initial stabilizer of an empty mLSTM / sLSTM state (the reference's)
M_INIT = -1e30


def _mlstm_dims(cfg):
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    di -= di % cfg.num_heads
    return d, di, cfg.num_heads, di // cfg.num_heads


class MLSTM(nn.Module):
    """The weights of one mLSTM mixer under the reference's leaf names and
    with its initial distributions, applied by ``mlstm_forward`` (prefill)
    and ``decode``.  ``w_if`` and ``b_if`` (the input and forget gates) are
    float32 whatever ``dtype`` is, as in the reference."""

    def __init__(self, gen: torch.Generator, cfg, dtype):
        super().__init__()
        d, di, H, hd = _mlstm_dims(cfg)
        dev = gen.device
        f32 = torch.float32
        self.cfg = cfg
        self.up_proj = layers.param(layers.dense_init(gen, d, 2 * di, dtype))
        self.conv_w = layers.param(
            (torch.randn((4, di), generator=gen, device=dev) * 0.5).to(dtype))
        self.conv_b = layers.zeros(di, dtype, dev)
        self.wq = layers.param(layers.dense_init(gen, di, di, dtype))
        self.wk = layers.param(layers.dense_init(gen, di, di, dtype))
        self.wv = layers.param(layers.dense_init(gen, di, di, dtype))
        self.w_if = layers.param(layers.dense_init(gen, di, 2 * H, f32))
        self.b_if = layers.param(torch.cat([
            torch.zeros((H,), dtype=f32, device=dev),
            torch.full((H,), 3.0, dtype=f32, device=dev)]))
        self.out_norm = layers.zeros(hd, dtype, dev)
        self.down_proj = layers.param(layers.dense_init(gen, di, d, dtype))

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        return mlstm_decode(self._parameters, x, state, self.cfg)


def _k_scale(hd: int, dtype) -> torch.Tensor:
    """``hd**-0.5`` as the reference multiplies by it: a Python float meets
    a compute-dtype array, so the constant is rounded to that dtype first
    (a 0-d CPU tensor, which a card tensor takes as a scalar)."""
    return torch.tensor(hd ** -0.5, dtype=dtype)


def _mlstm_qkv_gates(p, x: torch.Tensor, cfg):
    """x: (B, S, d) -> q, k (scaled by hd**-0.5), v (B, S, H, hd) in x's
    dtype; log_i, log_f (B, S, H) float32; z and the pre-conv input xm
    (B, S, di) in x's dtype (the reference returns all but xm, and its
    state computes xm again)."""
    _, di, H, hd = _mlstm_dims(cfg)
    cd = x.dtype
    B, S, _ = x.shape
    xm, z = (x @ p["up_proj"].to(cd)).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xm, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    q = (xc @ p["wq"].to(cd)).reshape(B, S, H, hd)
    k = (xc @ p["wk"].to(cd)).reshape(B, S, H, hd) * _k_scale(hd, cd)
    v = (xm @ p["wv"].to(cd)).reshape(B, S, H, hd)
    gates = xc.float() @ p["w_if"].float() + p["b_if"].float()
    log_i, f_pre = gates.chunk(2, dim=-1)           # (B, S, H)
    return q, k, v, log_i, F.logsigmoid(f_pre), z, xm


def mlstm_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d), the sequence mix through
    ``mlstm_attention`` (differentiable).  With ``return_state`` also the
    decode state the reference computes from the whole sequence: {"C"
    (B, H, hd, hd), "n" (B, H, hd), "m" (B, H), all float32, with the
    running stabilizer m = max_s D_Ss; "conv": the last 3 pre-conv inputs
    (B, 3, di) in x's dtype}.  Any S (the reference asserts S % 1024 == 0 once S > 1024);
    where S < 3 the conv state is zero-padded in front."""
    _, di, H, hd = _mlstm_dims(cfg)
    B, S, _ = x.shape
    cd = x.dtype
    q, k, v, log_i, log_f, z, xm = _mlstm_qkv_gates(p, x, cfg)
    # D_ts = F_t - F_s + log_i_s with F the inclusive cumulative log-forget:
    # step s's share at time t is (prod_{j=s+1..t} f_j) i_s
    Fc = torch.cumsum(log_f, dim=1)
    h = mlstm_attention(q, k, v, Fc, log_i)
    h = layers.head_rms_norm(h, p["out_norm"], cfg.norm_eps)
    out = (h.reshape(B, S, di) * F.silu(z)) @ p["down_proj"].to(cd)
    if not return_state:
        return out
    D_end = Fc[:, -1:] - Fc + log_i                 # (B, S, H)
    m_end = D_end.amax(dim=1)                       # (B, H)
    w = torch.exp(D_end - m_end[:, None])
    kf = k.float() * w[..., None]
    C = torch.einsum("bshd,bshe->bhde", kf, v.float())
    taps = p["conv_w"].shape[0] - 1
    tail = F.pad(xm, (0, 0, max(0, taps - S), 0))[:, -taps:]
    return out, {"C": C, "n": kf.sum(dim=1), "m": m_end,
                 "conv": tail.contiguous()}


def mlstm_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg) -> torch.Tensor:
    """Single-token step.  x: (B, 1, d); state {"C" (B, H, hd, hd), "n"
    (B, H, hd), "m" (B, H) float32, "conv" (B, 3, di)}, updated IN PLACE
    (the reference returns a new state).  The conv is one product over
    the window, summed in float32 and rounded once, as the reference's
    einsum is."""
    _, di, H, hd = _mlstm_dims(cfg)
    B = x.shape[0]
    cd = x.dtype
    xm, z = (x @ p["up_proj"].to(cd)).chunk(2, dim=-1)
    window = torch.cat([state["conv"].to(cd), xm], dim=1)   # (B, 4, di)
    conv = (window.float() * p["conv_w"].to(cd).float()).sum(1).to(cd)
    xc = F.silu(conv + p["conv_b"].to(cd))                   # (B, di)
    state["conv"].copy_(window[:, 1:])
    q = (xc @ p["wq"].to(cd)).reshape(B, H, hd).float()
    k = ((xc @ p["wk"].to(cd)).reshape(B, H, hd)
         * _k_scale(hd, cd)).float()
    v = (xm[:, 0] @ p["wv"].to(cd)).reshape(B, H, hd).float()
    gates = xc.float() @ p["w_if"].float() + p["b_if"].float()
    log_i, f_pre = gates.chunk(2, dim=-1)                    # (B, H)
    log_f = F.logsigmoid(f_pre)
    m = state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    f_sc = torch.exp(log_f + m - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    C = f_sc[..., None] * state["C"] \
        + i_sc[..., None] * (k[..., None] * v[..., None, :])
    n = f_sc * state["n"] + i_sc * k
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))
    h = layers.head_rms_norm((num / den[..., None]).to(cd), p["out_norm"],
                             cfg.norm_eps)
    h = h.reshape(B, 1, di) * F.silu(z)
    return h @ p["down_proj"].to(cd)


def init_mlstm_state(cfg, batch: int, dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    _, di, H, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=f32, device=device),
            "m": torch.full((batch, H), M_INIT, dtype=f32, device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory recurrent block)
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    """The weights of one sLSTM mixer under the reference's leaf names and
    with its initial distributions, applied by ``slstm_forward`` (prefill)
    and ``decode``.  The bias ``b`` is float32 whatever ``dtype`` is, as in
    the reference."""

    def __init__(self, gen: torch.Generator, cfg, dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        hd = d // H
        dev = gen.device
        f32 = torch.float32
        self.cfg = cfg
        # the i, f, z, o input weights
        self.w = layers.param(layers.dense_init(gen, d, 4 * d, dtype))
        self.r = layers.param(
            (torch.randn((4, H, hd, hd), generator=gen, device=dev)
             * hd ** -0.5).to(dtype))
        self.b = layers.param(torch.cat([
            torch.zeros((d,), dtype=f32, device=dev),
            torch.full((d,), 3.0, dtype=f32, device=dev),
            torch.zeros((2 * d,), dtype=f32, device=dev)]))
        self.out_norm = layers.zeros(hd, dtype, dev)

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        return slstm_decode(self._parameters, x, state, self.cfg)


def _slstm_step(r: torch.Tensor, pre_x: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One step.  r: the recurrent weights (4, H, hd, hd) float32; pre_x:
    the input's gate pre-activations ``x @ w + b`` as float32 (4, B, H, hd);
    state {"c", "n", "h", "m"} (B, H, hd) float32.  Returns the new
    state."""
    rec = torch.einsum("bhd,ghde->gbhe", state["h"], r)
    i_pre, f_pre, z_pre, o_pre = (pre_x + rec).unbind(0)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    c = f_sc * state["c"] + i_sc * torch.tanh(z_pre)
    n = f_sc * state["n"] + i_sc
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _gate_inputs(p, x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """x: (B, S, d) -> ``x @ w + b`` in x's dtype, widened to float32 and
    laid out (S, 4, B, H, hd) for the steps."""
    cd = x.dtype
    B, S, _ = x.shape
    xw = x @ p["w"].to(cd) + p["b"].to(cd)
    return xw.float().reshape(B, S, 4, H, hd).permute(1, 2, 0, 3, 4)


def slstm_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d): the recurrence stepped over S in a Python
    loop (the reference's ``lax.scan``; it has no kernel), from the empty
    state, differentiable by autograd: the steps read their inputs from
    one ``unbind`` and their outputs are stacked once (indexing a step's
    input, or writing its output into a buffer, would make a zero or a
    copy of the whole (S, ...) gradient at every step of the backward).
    With ``return_state`` also the final state {"c", "n", "h", "m"} (B,
    H, hd) float32."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    r = p["r"].float()
    state = init_slstm_state(cfg, B, device=x.device)
    hs = []
    for pre_t in _gate_inputs(p, x, H, hd).unbind(0):
        state = _slstm_step(r, pre_t, state)
        hs.append(state["h"])
    hs = torch.stack(hs, dim=1)                     # (B, S, H, hd)
    h = layers.head_rms_norm(hs.to(x.dtype), p["out_norm"], cfg.norm_eps)
    out = h.reshape(B, S, d)
    return (out, state) if return_state else out


def slstm_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg) -> torch.Tensor:
    """Single-token step.  x: (B, 1, d); state {"c", "n", "h", "m"} (B, H,
    hd) float32, updated IN PLACE (the reference returns a new state)."""
    B, _, d = x.shape
    H = cfg.num_heads
    hd = d // H
    new = _slstm_step(p["r"].float(), _gate_inputs(p, x, H, hd)[0], state)
    for name, t in new.items():
        state[name].copy_(t)
    h = layers.head_rms_norm(new["h"].to(x.dtype), p["out_norm"],
                             cfg.norm_eps)
    return h.reshape(B, 1, d)


def init_slstm_state(cfg, batch: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """The empty sLSTM state, float32 whatever the compute dtype, as in the
    reference."""
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, M_INIT, dtype=f32, device=device)}
