"""Why jamba's full-width training loss spikes at a high learning rate:
``train.run_training`` of jamba-v0.1-52b at full width, cut as
``chip_smoke.py``'s phase 16 cuts it (one period of 8 layers, no experts),
in variants that each take one suspect away.

    python -m repro_torch.launch.train_ablation

Every variant trains 6 steps at peak learning rate LR (warmup 20) from the
same seed and batches, batch 4 x 2048, one pod, mode 3 without a
compressor:

  jamba      bf16 compute, as phase 16 trains; every ``mamba_scan_backward``
             call is run once more on batch row 0 alone and held against
             ``mamba_scan_backward_torch`` on the same inputs: the step's
             own scan inputs and output gradients, the spike's included
  float32    the same in float32 compute: no bf16 rounding anywhere
  attention  every mixer attention: no Mamba block, so neither scan kernel

Prints one JSON line a variant: losses, grad norms, learning rates, ms a
step and the peak memory; for ``jamba`` also each step's largest
difference of a gradient from the plain backward's, as a share of that
gradient's largest magnitude.  Needs a CUDA device.
"""
from __future__ import annotations

import json
from unittest import mock

import torch

from repro_torch.configs import get_config
from repro_torch.core.modes import AsyncMode
from repro_torch.data.synthetic import DataConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch import train
from repro_torch.optim.adamw import AdamWConfig

#: phase 16's cut of jamba-v0.1-52b: one period, no experts
CUT = dict(num_layers=8, num_experts=0, experts_per_tok=0, moe_d_ff=0)
STEPS, BATCH, SEQ = 6, 4, 2048
#: the rate phase 13 trains deepseek-moe-16b at, where jamba's loss spikes
LR = 3e-3


def held_backward(shares):
    """A stand-in for ``ops.mamba_scan_backward`` that returns the kernel's
    gradients and appends to ``shares`` the largest difference, on batch
    row 0, between the kernel's five gradients and the plain backward's,
    each as a share of the plain gradient's largest magnitude."""
    kernel = scan_ops.mamba_scan_backward

    def backward(x, dt, B, C, A, dy, dh_final=None, hbound=None):
        assert dh_final is None, "training uses no final state"
        out = kernel(x, dt, B, C, A, dy, None, hbound)
        row = [t[:1] for t in (x, dt, B, C)] + [A, dy[:1]]
        got = kernel(*row)
        want = scan_ops.mamba_scan_backward_torch(*row)
        shares.append(max(
            float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)))
        return out

    return backward


def run(label, cfg, shares=None):
    spec = train.TrainSpec(mode=AsyncMode.BEST_EFFORT,
                           adamw=AdamWConfig(lr=LR, warmup_steps=20,
                                             total_steps=STEPS))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, history = train.run_training(
        cfg, spec, DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0),
        steps=STEPS, log_every=1, device="cuda", seed=0)
    del state
    rec = dict(variant=label, peak_lr=LR, dtype=cfg.dtype,
               mixers=sorted(set(cfg.block_pattern)),
               device=torch.cuda.get_device_name(0),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **{k: [h[k] for h in history]
                  for k in ("loss", "grad_norm", "lr", "ms")})
    if shares is not None:
        per = len(shares) // STEPS
        rec["scan_backward_vs_plain"] = [max(shares[i:i + per])
                                         for i in range(0, len(shares), per)]
    print(json.dumps(rec), flush=True)
    return rec


def main():
    cfg = get_config("jamba-v0.1-52b").replace(**CUT)
    shares = []
    with mock.patch.object(scan_ops, "mamba_scan_backward",
                           held_backward(shares)):
        run("jamba", cfg, shares)
    run("float32", cfg.replace(dtype="float32"))
    run("attention", cfg.replace(block_pattern=("attn",)))


if __name__ == "__main__":
    main()
