"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It drives the port's main paths (the vectorized best-effort engine on the
dense layout with the hand-written CUDA ``duct_window`` / ``duct_commit``
kernels, on the edge-major layout with the ``duct_exchange`` kernel,
sharded with the ``duct_exchange`` kernel's drain and send on both
layouts, with
the graph-coloring app's int32 halos and the evo app's float32 halos, in
batch runs and as a live service with open-loop arrivals and churn; the
dense LM's serving path, prefill through the ``flash_attention`` kernel
and greedy decode through the ``decode_attention`` kernel; and the dense
LM's training path in best-effort mode 3, attention through
``flash_attention`` and the lossy cross-pod payload through the
``quantize`` / ``dequantize`` or ``topk_compress`` kernels; the hybrid
jamba's serving path, its Mamba prefill through the ``mamba_scan`` kernel,
its one attention layer through the two attention kernels; xlstm-125m's
serving path, its mLSTM prefill through the ``mlstm_attention`` kernel;
the MoE archs' serving and training paths and the audio and vision
archs' serving path with their frontend prefix, through the two attention
kernels and, in training, ``topk_compress``; the jamba and xLSTM blocks'
training path, through ``mamba_scan`` and ``mlstm_attention`` forward and
their hand-written backward kernels ``mamba_scan_backward`` and
``mlstm_attention_backward``; the SPMD tools, the conduits, the
best-effort collectives through the compression kernels and graph
coloring's in-graph step) and fails with a non-zero exit code if any
phase fails:

  1. card      the ``nvidia-smi`` name and power limit
  2. build     the twelve kernels from ``csrc/`` into ``build/`` (eleven
               sources, one nvcc each, started together)
  3. kernels   each kernel, and each float32 entry point, against its plain
               torch version on the same CUDA inputs at the main paths'
               shapes, with the device time of both (torch.profiler), their
               time per call with launch overhead (CUDA events) and the
               bound: the duct kernels bitwise, ``duct_exchange`` through
               its three entry points (routes ``full``, ``drain`` and
               ``send``; the drain's bound without the q_touch copy it no
               longer makes); the
               attention kernels within a stated tolerance, with the time
               of the one PyTorch call that computes the same function
               (``scaled_dot_product_attention``) beside them:
               ``flash_attention``'s tensor-core route at the prefill
               shape, at hd 64, at a ragged S, at G = 1 (hd 128 and
               64: the MHA prefills) and at G = 4 (llava-next-mistral-7b's
               prefill), its CUDA-core route at
               float32 and at bf16 hd 16, each call's route read from
               ``build.ROUTES`` (as for every kernel with routes below);
               ``decode_attention`` as the whole function (one launch,
               partials and combine) against the plain
               whole function at kv_len 2049, 2080 and 1, and at G = 1
               (hd 128 and 64) and G = 4 (kv_len 2049); the
               compression kernels bitwise at every row shape of
               qwen2-1.5b's gradient leaves, ties and a ragged final
               block (``q * scale`` timed beside dequantize; every top-k
               shape and the tie-heavy ones timed with ``torch.topk`` of
               |x| beside them, each call's route read from
               ``build.ROUTES``; one row of 184,549,376 entries, k =
               1,845,493: a deepseek-moe-16b expert leaf); ``mamba_scan`` at
               jamba's prefill shape (8, 2048, 8192, 16) on its ``tma``
               route and, on the same inputs, its ``simt`` route, with the
               blocks of each resident on an SM, a ragged ``tma`` shape on
               both routes and a ``simt`` shape, within a stated tolerance
               (no PyTorch call computes the scan); ``mlstm_attention``
               at xlstm-125m's prefill shape (8, 2048, 4, 384) bf16 on
               its tensor-core route and, on the same inputs, its
               CUDA-core route (the tensor-core
               route must be the faster), at a float32 shape and at a
               ragged one on both routes within a stated tolerance (no
               PyTorch call computes the mLSTM's signed, max-clamped
               normaliser); ``duct_commit_f32`` must be faster than its
               plain version; the two backward kernels within a stated
               share of each gradient's largest magnitude:
               ``mamba_scan_backward`` at jamba's training shape (4, 2048,
               8192, 16), run twice for bitwise equal gradients, and at
               S = 2047 with di % 4 != 0 and at N = 4, 8, 32;
               ``mlstm_attention_backward`` at xlstm-125m's training shape
               (4, 2048, 4, 384) bf16 and at hd 64, 128 and 384 in bf16
               and float32 at S = 2047
  4. oracle    dyadic 16-process scenarios (2**-8 s) on both duct
               layouts: the torch engine on the card gives the event
               simulator's ``qos_signature``
  5. card=cpu  torus-1024 (64 simels, L=8), smallworld-1024, torus-1024 on
               the edge layout, and evo on a 64-process torus (dense, W=4,
               edge) on the card (kernels) and on the CPU (plain
               versions), dyadic at 2**-9 s: equal SimResults
  6. full size graph coloring on the torus 64x64 = 4096 processes, 1
               simel, buffer 64, duration 0.02, best-effort: per-window
               dense, --superstep-windows 8 and --layout edge (all three
               equal); evo at the paper's 3600 cells per process on the
               torus-1024, duration 0.0025: per-window dense,
               --superstep-windows 8 and --layout edge (all three equal).
               Launch counters are zeroed just before each path and read
               just after it; an edge window is one ``drain`` and one
               ``send`` launch
  7. lm card=cpu  the reduced qwen2-1.5b and qwen3-0.6b (2 layers),
               jamba-v0.1-52b (one 8-layer period) and xlstm-125m (6
               layers; float32 only) served on the card
               (kernels) and on the CPU (plain versions) from the same
               seeded weights: logits at every step with teacher forcing,
               exact launch counts (flash on its CUDA-core route: hd
               16), equal greedy tokens in float32; jamba
               in bf16 on its caches up to the first MoE layer and on one
               MoE layer given the same inputs (its routing makes the
               logits discontinuous in bf16 roundings)
  8. lm full size  qwen2-1.5b at full width in bf16 through
               ``repro_torch.launch.serve``: batch 8, prompt 2048, 32 new
               tokens; 28 flash launches per prefill, all on the
               tensor-core route, 28 decode launches per step; prefill of
               the prompt plus k generated tokens gives decode step k's
               logits; a second serve gives the same tokens; then
               ``profile_serve.profile_serving`` over one prefill and 8
               decode steps
  9. train card=cpu  the reduced qwen2-1.5b and qwen3-0.6b in float32,
               modes 0-4 at n_pods = 2 and mode 3 with int8 and with
               top-k: 3 steps on the card (kernels) and on the CPU (plain
               versions) from the same state agree, with exact launch
               counts, mode 3's sums (plain and lossy) counted through
               ``collectives.cross_pod_sum`` (a leaf a step); a
               checkpoint saved on the card restores on the CPU
  10. train full size  qwen2-1.5b at full width through
               ``repro_torch.launch.train``: bf16 compute, float32
               masters, batch 4 x seq 2048, mode 3, 6 steps with top-k
               and 6 with int8: exact launch counts (flash on its
               tensor-core route), finite and falling
               loss; the three kernels on step 1's real gradient leaves
               equal their plain versions
  11. jamba full size  one 8-layer period of jamba-v0.1-52b at full width
               (d 4096, 16 experts top-2, 13.3 G parameters; depth cut
               from 32) in bf16 through ``serve.serve``: batch 8, prompt
               2048, 32 new tokens; exact launches (7 ``mamba_scan``, all
               on the ``tma`` route, and 1 ``flash_attention``,
               tensor-core route, per prefill, 1
               ``decode_attention`` per step), finite logits, the same
               tokens from a second serve;
               the kernel against its plain version on layer 0's real scan
               inputs; layer 0's Mamba state after a prefill of prompt + k
               tokens equals its state after k decode steps (k = 1, 31);
               then ``profile_serve.profile_serving`` over one prefill and
               8 decode steps
  12. xlstm full size  xlstm-125m at full width, depth cut to one
               period of its block pattern (12 -> 6 layers: five mLSTM,
               one sLSTM; d 768, 97.1 M parameters) in bf16 through
               ``serve.serve``: batch 8, prompt 2048, 32 new
               tokens; exact launches (5 ``mlstm_attention`` per
               prefill, all on the tensor-core route; no other kernel),
               finite logits, the same tokens
               from a second serve; the kernel against its plain version
               on layer 0's real inputs; prefill of the prompt plus k
               generated tokens gives decode step k's logits (k = 1, 31)
               within XLSTM_CROSS_REL; ``profile_serve.profile_serving``
               over one prefill and 8 decode steps; then the same serve
               in float32 (5 launches on the CUDA-core route), prefill
               against decode at float32's precision
  13. moe full size  the reduced deepseek-moe-16b and dbrx-132b card =
               CPU (phase 7's serving check, float32 and bf16; phase 9's
               training check, float32, mode 3 top-k and mode 0, the aux
               loss too); deepseek-moe-16b uncut (28 layers, 16.9 G
               parameters) through ``repro_torch.launch.serve`` and
               dbrx-132b at full width (depth cut 40 -> 8, built in bf16)
               through ``serve.serve``: batch 8, prompt 2048, 32 new
               tokens in bf16, exact launches (flash one a layer on the
               tensor-core route, decode one a layer and step), finite
               logits, the same tokens from a second serve, profiled;
               then deepseek-moe-16b trained at full width (depth cut 28
               -> 3) through ``train_run`` (``train.run_training``: bf16
               over float32 masters, batch 4 x 2048, 6 steps, exact
               launches and routes, falling loss), mode 3 with top-k,
               positive aux loss
  14. modality full size  the reduced musicgen-large and
               llava-next-mistral-7b card = CPU with the frontend prefix
               spliced (float32 and bf16), one training step each from the
               ``Pipeline``'s batches on the card equal to the CPU's; both
               uncut through ``repro_torch.launch.serve``: batch 8, prompt
               2048 (its first 256 or 576 positions the frontend prefix),
               32 new tokens in bf16, exact launches, the same tokens from
               a second serve, prefill of the prompt plus k tokens against
               decode step k (phase 8's tolerance), profiled
  15. ssm train card=cpu  the reduced jamba-v0.1-52b and xlstm-125m in
               float32: one pass's ce, aux and every gradient leaf on the
               card (kernels, forward and backward) equal the CPU's, exact
               launches
  16. jamba train full size  jamba-v0.1-52b at full width cut to one
               period with no experts (2.73 G parameters) through
               ``train_run``: remat, mode 3 uncompressed, 7
               ``mamba_scan_backward`` launches a step, falling loss, the
               peak printed; then one step profiled
               (``profile_train.profile_step``)
  17. xlstm train full size  xlstm-125m at full width, phase 12's
               6 layers, through ``train_run`` (2 steps):
               mode 3 with top-k, 5 ``mlstm_attention_backward`` launches
               a step, falling loss; one sLSTM layer's training work
               profiled (its Python loop's launches and busy share)
  18. sharded  the sharded engine, all shards on the card: phase 4's
               scenarios at 8 shards (one row order) give the event
               oracle's signature; 8 shards on the card equal the CPU's
               (phase 5's torus-1024 under the window, W=8 superstep and
               W=8 pipelined schedulers, evo on torus-64); phase 6's
               torus-4096 at 8 shards equals its unsharded result, then
               the 8-shard window again, W=8 superstep, W=8 pipelined and
               64 shards (0.005 s):
               windows executed and needed, duct launches a window (the
               edge-major ``drain`` and ``send`` only), hops a superstep,
               bytes a hop; the paper's faulty
               node (cliques-256, 8 shards, W=8, 0.005 s, through the CLI's
               faults family): the clique's and the global median QoS
               beside the fault-free run
  19. service  the live-service path (open-loop arrivals, churn epochs,
               SLO verdicts): the dyadic serve scenarios (poisson, diurnal,
               bursty under the rolling barrier) on torus-16, dense and
               edge on the card, give the event oracle's ``service`` and
               ``qos_signature``; ``run_service`` with churn 2 and two
               replicates on the card equals the CPU's whole output dict
               (graph coloring on torus-1024, evo on torus-64 with 16
               cells; dense, W=4 and edge, all three equal on the
               card); at full width through ``--family serve`` (graph
               coloring on torus-4096, 1 simel, buffer 64, duration 0.01,
               ``--arrival-rate 1e5``): bursty traffic with churn 2 (five
               epochs: a host fault and heal, a process leave and
               rejoin), dense equal to edge, and poisson with churn 1 at 8
               shards equal to unsharded, each with its epochs, service
               totals, SLO summary, wall s, updates/s, windows executed
               and needed, duct launches a window and the time outside
               the windows; then ``profile_window`` without and with
               arrivals on the dense window: the serve hook's CUDA
               launches and device time a window
  20. spmd     the SPMD tools, every mesh axis a tensor dimension on the
               card: the conduits on an 8-long ring, modes 0-4, with the
               reference's staleness semantics, card == CPU;
               ``exchange_gradients`` at 2 pods, modes 0-4, two steps,
               with the reference's values; ``cross_pod_sum`` with int8
               and with top-k on a (2, 8960, 1536) leaf (qwen2-1.5b's
               width), card == CPU bitwise, its ``quantize`` /
               ``dequantize`` / ``topk_compress`` launches counted; graph
               coloring's ``spmd_step`` on the reference's (16, 16)
               production mesh of 256 x 256 blocks (16.8 M nodes): 8
               best-effort steps card == CPU bitwise, then 400 steps in
               modes 0, 3, 4 and 1 (flush every 8 steps), each with ms a
               step, node updates/s, CUDA launches a step and the busy
               share (profiled), conflicts over the first and the last 10
               steps (best effort must fall); at the reference's own size
               (2 x 2 of 16 x 16, 400 steps) best effort meets its
               criterion (last 10 < 0.3 x first 10)
  21. replicates  batched replicates, a sweep of seeds in one carry: (a)
               the weak-scaling sweep through the CLI, ``--procs 256
               --replicates 32`` (8192 processes in one carry; duration
               cut to 0.00025), then the same seeds through the sequential
               loop, every SimResult field equal; wall s, duct launches a
               window and busy share of both; seeds of phase 4's lossy
               torus-16 that stop in different windows, one window a
               chunk: each replicate equals its own run; (b) phase 6's graph
               coloring torus-4096 (0.0025 s) at R = 8, dense window and W =
               8: duct launches a window equal phase 6's R = 1, ms a
               window and updates/s summed over the replicates beside
               phase 6's; card == CPU at R = 3 on
               graph coloring torus-256 (int32) and evo torus-64
               (float32); (c) torus-4096 at R = 4 (0.0025 s): 8 shards ==
               unsharded, every SimResult field; then the duct kernels at
               the shapes one launch covers there, against their plain
               versions, with their bounds
  22. ranks    the shard axis over torch.distributed ranks: (a) gc
               torus-4096 at 8 shards over 2 gloo ranks that the phase
               spawns on the one card (boundary buffers and release
               reductions staged through pinned host memory), under the
               window and W=8 pipelined schedulers (0.005 s):
               every SimResult field of each rank equals phase 18's
               one-process run; and in barrier mode 0 (0.00125 s, every
               window a release all-reduced) equal to the one-process
               run made here; (b) the window and pipelined runs over 1
               NCCL rank in this process; (c) phase 20's (16, 16) mesh of
               256 x 256 blocks, its rows over the 2 gloo ranks, 20
               best-effort steps equal to one process bitwise; (d) per
               run and rank: ms a window, duct launches a window, hops
               and the exchanges that move them a window (the hops one
               phase has ready go in one exchange, one wait on the card),
               the hops' host and device ms a window, bytes a hop,
               all-reduces a window, beside the one-process run's
  23. train_ranks  training's pod axis over torch.distributed ranks:
               qwen3-0.6b uncut (bf16 compute, float32 masters), batch 4
               x 2048 at n_pods = 2, 3 steps each of mode 0, mode 3 int8
               and mode 3 top-k through ``train.run_training``, in one
               process, over 2 gloo ranks sharing the card (one pod each;
               payloads staged through pinned host memory) and over 1
               NCCL rank holding both pods: every rank's losses, grad
               norms and final parameters equal the one process's
               bitwise, launches and routes exact per rank; ms a step,
               all-gathered bytes a step, the all-gathers' host time and
               peak memory beside the one process's; the compression
               kernels held to their plain versions on rank 0's step-1
               payload

It imports nothing of JAX or of the JAX package.  The line before the last
is a JSON object with one record per kernel and float32 entry point (the
edge-major drain and send add ``sharded_launches``, their launches on
phase 18's 8-shard torus-4096 run; the duct entries add
``service_launches``, their launches in phase 19's runs on the card; the
compression kernels add ``spmd_launches``, theirs in phase 20's sums; the
dense duct entries add ``replicates_launches``, theirs in phase 21 (b);
flash_attention and the compression kernels add ``train_ranks_launches``,
theirs in phase 23's one-process runs);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import hashlib
import json
import math
import os
import pickle
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.apps import graphcolor  # noqa: E402
from repro_torch.apps.graphcolor import (  # noqa: E402
    GraphColorApp,
    GraphColorConfig,
)
from repro_torch.core import collectives, conduit  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.core.qos import aggregate_reports, qos_signature  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build as K  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_torch,
)
from repro_torch.kernels.duct_exchange.ops import (  # noqa: E402
    duct_commit,
    duct_commit_torch,
    duct_drain,
    duct_drain_torch,
    duct_exchange,
    duct_exchange_torch,
    duct_send,
    duct_send_torch,
    duct_window,
    duct_window_torch,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_grouped,
    flash_attention_torch,
)
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import Pipeline  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.quantize import (  # noqa: E402
    dequantize_blocks,
    dequantize_torch,
    quantize_blocks,
    quantize_torch,
)
from repro_torch.kernels.topk_compress import (  # noqa: E402
    topk_compress_blocks,
    topk_compress_torch,
)
from repro_torch.kernels.topk_compress.kernel import (  # noqa: E402
    route as topk_route,
)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan,
    mamba_scan_torch,
)
from repro_torch.kernels.mamba_scan.ops import (  # noqa: E402
    mamba_scan_backward,
    mamba_scan_backward_torch,
)
from repro_torch.kernels.mamba_scan.kernel import (  # noqa: E402
    blocks_per_sm as mamba_blocks_per_sm,
    mamba_scan_cuda,
    route as mamba_route,
)
from repro_torch.kernels.mlstm_attention import (  # noqa: E402
    mlstm_attention,
    mlstm_attention_plain,
)
from repro_torch.kernels.mlstm_attention.kernel import (  # noqa: E402
    route as mlstm_route,
    mlstm_attention_backward_cuda,
    mlstm_attention_cuda,
)
from repro_torch.kernels.mlstm_attention.ops import (  # noqa: E402
    mlstm_attention_backward,
    mlstm_attention_backward_plain,
)
from repro_torch.launch import (  # noqa: E402
    mesh,
    profile_serve,
    profile_train,
    serve,
    train,
)
from repro_torch.models import layers, lm, moe, ssm, transformer  # noqa: E402
from repro_torch.models.modality import frontend_input_name  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    Int8Compressor,
    TopKCompressor,
)
from repro_torch.optim.outer import OuterConfig  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    engine_torch,
    experiments,
    profile_window,
)
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.engine_sharded import ShardedTorchEngine  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultModel,
    crashed_host,
    lossy_host,
)
from repro_torch.runtime.service import (  # noqa: E402
    default_timeline,
    run_service,
)
from repro_torch.runtime.simulator import SimConfig  # noqa: E402
from repro_torch.runtime.topologies import make_topology  # noqa: E402

#: HBM bandwidth by SKU (NVIDIA data sheets); the card's name picks the row
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
#: float32 peak outside the tensor cores (H100 SXM data sheet); the duct
#: kernels' integer compares and copies are counted against it, and so are
#: the attention kernels' float32 entry points
PEAK_OPS_PER_S = 67e12
#: bf16 dense tensor-core peak (H100 SXM data sheet): the attention
#: kernels' bf16 bound, whatever units they run on
PEAK_BF16_FLOPS = 989e12

#: dyadic timing constants (power-of-two, no stochastic clocks): float32
#: and float64 clock arithmetic are exact, so every engine agrees bitwise
DYADIC = dict(
    duration=2.0 ** -7, base_compute=2.0 ** -16,
    per_message_cost=2.0 ** -23, per_pull_cost=2.0 ** -22,
    base_latency=2.0 ** -13, barrier_base=2.0 ** -15,
    barrier_per_log2=2.0 ** -16, rolling_quantum=2.0 ** -11,
    fixed_interval=2.0 ** -10, snapshot_warmup=2.0 ** -10,
    snapshot_interval=2.0 ** -11, jitter_sigma=0.0, stall_prob=0.0,
    latency_sigma=0.0)
QUARANTINE_TAU = 2.0 ** -10
EXACT_MAX_POPS = 64

PHASES = []


def phase(name):
    """Decorator: run a phase, print its wall time; any exception fails
    the whole script (no phase failure is turned into a pass)."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            PHASES.append((name, dt))
            print(f"[phase {name}] ok in {dt:.1f}s", flush=True)
            return out
        return run
    return wrap


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------
@phase("card")
def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    hbm = next(v for k, v in HBM_BYTES_PER_S.items() if k in name) \
        if any(k in name for k in HBM_BYTES_PER_S) else 3.35e12
    return smi, name, hbm


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
@phase("build")
def build():
    secs = K.build()
    for name in K.SOURCES:
        check(K.library_path(name).exists(), f"{name} library missing")
    check(len(K.SOURCES) == 12, f"expected twelve kernels, got {K.SOURCES}")
    print(f"built {sorted(K.SOURCES)} in {secs:.1f}s into {K.BUILD_DIR}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain, bitwise, with times
# ---------------------------------------------------------------------------
def payload(rng, shape, dtype):
    """Random payloads: small ints for int32, normals for float32."""
    if dtype == np.float32:
        return rng.standard_normal(shape, dtype=np.float32)
    return rng.integers(0, 99, shape).astype(np.int32)


def window_state(rng, n, d, C, L, cap, dev, pay=np.int32):
    """Random dense ring state as the tests build it (vectorized): live
    FIFO prefixes from a random head, an engine-style staged push."""
    head = rng.integers(0, C, (n, d)).astype(np.int32)
    size = rng.integers(0, cap, (n, d)).astype(np.int32)
    off = (np.arange(C)[None, None, :] - head[..., None]) % C
    live = off < size[..., None]
    qa = np.where(live, rng.random((n, d, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (n, d, C)), 0).astype(np.int32)
    qp = np.where(live[..., None], payload(rng, (n, d, C, L), pay),
                  0).astype(pay)
    pacc = (rng.random((n, d)) < 0.7) & (size < cap)
    ppos = ((head + size) % C).astype(np.int32)
    size = (size + pacc).astype(np.int32)
    pav = (rng.random((n, d)) * 2).astype(np.float32)
    ptch = rng.integers(0, 50, (n, d)).astype(np.int32)
    ppay = payload(rng, (n, d, L), pay)
    rnow = (rng.random(n) * 2).astype(np.float32)
    ract = rng.random(n) < 0.8
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size, ppos, pacc, pav, ptch, ppay, rnow, ract)]


def commit_state(rng, R, C, L, W, dev, pay=np.int32):
    qa = (rng.random((R, C)) * 2).astype(np.float32)
    qt = rng.integers(0, 50, (R, C)).astype(np.int32)
    qp = payload(rng, (R, C, L), pay)
    head = rng.integers(0, C, R).astype(np.int32)
    size0 = rng.integers(0, C, R).astype(np.int32)
    cnt = np.minimum(rng.integers(0, W + 1, R), C - size0).astype(np.int32)
    pa = (rng.random((R, W)) * 2).astype(np.float32)
    pt = rng.integers(0, 50, (R, W)).astype(np.int32)
    pp = payload(rng, (R, W, L), pay)
    return [torch.as_tensor(a, device=dev) for a in
            (qa, qt, qp, head, size0, cnt, pa, pt, pp)]


def commit_read(args):
    """The bytes a commit must read on these inputs: head, size0 and
    pb_cnt, the ring slots it keeps, and the pushbuf entries it lands
    (the first min(pb_cnt, W) of each ring); the rest of the pushbuf is
    never needed."""
    qa, _, qp, head, size0, cnt = args[:6]
    R, C = qa.shape
    W, L = args[6].shape[1], qp.shape[-1]
    slot = 8 + L * qp.element_size()
    landed = int(cnt.clamp(max=C).sum())
    used = int(cnt.clamp(max=W).sum())
    return nbytes(head, size0, cnt) + (R * C - landed + used) * slot


def exchange_state(rng, E, C, dev):
    """Random edge-major rings (a quarter of them full) with random
    receiver and sender activity."""
    head = rng.integers(0, C, E).astype(np.int32)
    size = rng.integers(0, C + 1, E)
    size = np.where(rng.random(E) < 0.25, C, size).astype(np.int32)
    off = (np.arange(C)[None, :] - head[:, None]) % C
    live = off < size[:, None]
    qa = np.where(live, rng.random((E, C)) * 2, np.inf).astype(np.float32)
    qt = np.where(live, rng.integers(0, 50, (E, C)), 0).astype(np.int32)
    return [torch.as_tensor(a, device=dev) for a in (
        qa, qt, head, size, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.8, (rng.random(E) * 2).astype(np.float32),
        rng.random(E) < 0.7, (rng.random(E) * 0.5).astype(np.float32),
        rng.integers(0, 50, E).astype(np.int32))]


def drain_bytes(args, pops):
    """What the drain must read and write on these inputs: q_avail both
    ways, the per-edge inputs and outputs, and one q_touch slot for each
    ring that pops (the freshest popped message's touch).  The drain
    returns its input q_touch unchanged: no copy of it is work the
    function needs."""
    qa, qt, head, size, rnow, ract = args[:6]
    d = duct_drain_torch(*args[:6], max_pops=pops)
    popped = int((d.drained > 0).sum())
    return dict(read=nbytes(qa, head, size, rnow, ract)
                + popped * qt.element_size(),
                written=nbytes(d.q_avail, d.head, d.size, d.drained,
                               d.recv_touch, d.pop_pos))


def one_launch(kernel, label, run, route):
    """Run ``run`` once with the counters zeroed; check it was one launch
    of ``kernel``, on ``route`` (None: a kernel with one route), and
    nothing else.  Returns its output."""
    K.reset_launches()
    out = run()
    torch.cuda.synchronize()
    routes = {} if route is None else {f"{kernel}/{route}": 1}
    check(K.ROUTES == routes and K.LAUNCHES[kernel] == 1
          and sum(K.LAUNCHES.values()) == 1,
          f"{kernel} {label}: launches {K.LAUNCHES}, routes {K.ROUTES}, "
          f"expected one on {route}")
    return out


def device_ms(fn, runs=10, warmup=3):
    """(device time per call, how it was taken).  The CUDA kernel time
    torch.profiler records over ``runs`` calls, divided by ``runs``:
    host-side launch overhead is excluded, so a small kernel is not timed
    as its wrapper's Python ("profiler").  A trace that records no device
    time at all (the card's tracing sometimes delivers no kernel records)
    is taken again, up to three times; after that, CUDA events around
    ``runs`` back-to-back calls time it instead, launch overhead included
    ("events"), and the kernel's record says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / runs, "profiler"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / runs
    check(ms > 0, "neither torch.profiler nor CUDA events timed the call")
    print(f"torch.profiler recorded no device time in three traces; CUDA "
          f"events time the call at {ms:.4f} ms", flush=True)
    return ms, "events"


def call_ms(fn, runs=15, warmup=3):
    """Median time per call between CUDA events around it, host launch
    overhead included (what the engine pays per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(want, got):
    """(mismatching elements, max |difference|) over every output field."""
    bad, err = 0, 0.0
    for a, b in zip(want, got):
        eq = (a == b) | ((a != a) & (b != b))
        bad += int((~eq).sum())
        if not bool(eq.all()):
            d = (a.double() - b.double()).abs()
            err = max(err, float(torch.where(eq, 0.0, d).max()))
    return bad, err


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_close(want, got, rtol, atol):
    """(elements that disagree, max |difference|) over every output field.
    An element agrees when it equals the plain one (equal infinities
    included) or when both are finite and |got - want| <= atol + rtol
    |want|.  A NaN, or an infinity on one side only, disagrees and makes
    the max |difference| NaN or infinite."""
    bad, err = 0, 0.0
    for a, b in zip(want, got):
        a, b = a.double(), b.double()
        same = a == b
        d = torch.where(same, 0.0, (a - b).abs())
        close = torch.isfinite(a) & torch.isfinite(b) & (
            d <= atol + rtol * a.abs())
        bad += int((~(same | close)).sum())
        e = float(d.max())
        err = e if (e != e or e > err) else err     # a NaN stays
    return bad, err


def compare_scaled(want, got, tol):
    """(elements that disagree, max |difference|) over every output field,
    an element agreeing when |got - want| <= tol x the field's largest
    |want|: a gradient summed over many terms (dA over batch and time, dF
    over keys) has entries near 0 whose own scale says nothing."""
    bad, err = 0, 0.0
    for a, b in zip(want, got):
        a, b = a.double(), b.double()
        d = (a - b).abs()
        scale = float(a.abs().max())
        ok = torch.isfinite(b) & (d <= tol * scale)
        bad += int((~ok).sum())
        e = float(d.max())
        err = e if (e != e or e > err) else err
    return bad, err


def fields(x):
    return x if isinstance(x, tuple) else (x,)


def measure(label, run_kernel, run_plain, inputs, ops, hbm, *,
            peak=PEAK_OPS_PER_S, tol=None, library=None, plain_runs=None,
            read=None, written=None, scaled=None):
    """Hold one kernel call against its plain version (0 mismatching
    elements, or with ``tol = (rtol, atol)`` every element within it, or
    with ``scaled`` every element within that share of its field's largest
    magnitude, ``compare_scaled``), time
    both (device time, and per call with the launch overhead), time
    ``library`` (the one PyTorch call that computes the same function,
    where there is one), record how each of the three device times was
    taken (``*_by``: "profiler" or "events", see ``device_ms``), and
    compute the bound for the same work: each
    input read once and each output written once over the HBM rate, or
    the operations over ``peak``, whichever is longer; ``read`` replaces
    the inputs' bytes where the work depends on the data (the bytes these
    inputs need read), ``written`` the outputs' bytes where an output is
    an input handed back unchanged.  ``plain_runs`` cuts the plain
    version's timed calls (for a plain version that launches thousands of
    small kernels a call)."""
    want = fields(run_plain())
    got = fields(run_kernel())
    torch.cuda.synchronize()
    if scaled is not None:
        bad, err = compare_scaled(want, got, scaled)
        check(bad == 0, f"{label}: {bad} elements further than {scaled} of "
                        f"their field's largest magnitude from the plain "
                        f"version (max |difference| {err:.3g})")
        agree = (f"max |difference| {err:.3g}, within {scaled} of each "
                 f"field's largest magnitude")
    elif tol is None:
        bad, err = compare(want, got)
        check(bad == 0, f"{label}: {bad} mismatching elements")
        agree = "0 mismatches"
    else:
        bad, err = compare_close(want, got, *tol)
        check(bad == 0, f"{label}: {bad} elements outside rtol, atol = "
                        f"{tol} (max |difference| {err:.3g})")
        agree = f"max |difference| {err:.3g} within rtol, atol = {tol}"
    ms, ms_by = device_ms(run_kernel)
    plain, plain_by = device_ms(run_plain, runs=plain_runs or 10)
    call = call_ms(run_kernel)
    plain_call = call_ms(run_plain, runs=plain_runs or 15)
    lib, lib_by = device_ms(library) if library is not None else (None, None)
    moved = (nbytes(*inputs) if read is None else read) + \
        (nbytes(*got) if written is None else written)
    t_bytes, t_ops = moved / hbm, ops / peak
    bound = max(t_bytes, t_ops) * 1e3
    lib_txt = f", library {lib:.4f} ms" if lib is not None else ""
    print(f"{label}: {agree}, kernel {ms:.4f} ms, plain {plain:.4f} "
          f"ms{lib_txt} (device time), bound {bound:.4f} ms, "
          f"{ms / bound:.1f}x bound ({moved / 1e6:.1f} MB moved, "
          f"{ops / 1e9:.2f} G operations); per call with launch "
          f"overhead: kernel {call:.4f} ms, plain {plain_call:.4f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib, ms_by=ms_by, plain_ms_by=plain_by,
                library_ms_by=lib_by)


#: attention tolerances (rtol, atol) against the plain versions on the
#: card.  Float32 differs only in the order of the sums (online softmax over
#: tiles and chunks).  In bf16 both sides compute in float32 (the
#: tensor-core flash route carries p in two bf16 terms, to ~2^-17) and
#: round once to bf16, so they differ by at most one bf16 ulp, which is at
#: most 2^-7 of the value; atol covers the float32 sums' own error where
#: the output is near 0
ATTN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}
#: max |SDPA - plain version|, which shows that the library call times the
#: same function: SDPA rounds its bf16 probabilities, the plain version
#: does not
SDPA_TOL = {torch.float32: 4e-4, torch.bfloat16: 8e-2}


def attention_kernels(hbm):
    """flash_attention's tensor-core route (bf16, hd 64 and 128) at the
    qwen2-1.5b prefill shape (B*KH = 16, G = 6, S = 2048, hd = 128), at hd
    64, at a ragged S and at the MHA and llava prefills (G = 1 at hd 128
    and 64, G = 4), and its CUDA-core route at float32 and at bf16 hd 16
    (the reduced configs' head dim), each call's route read from
    ``K.ROUTES``; decode_attention, the whole function in one launch (the
    partials are no longer the kernel's output), at the decode shape (B =
    8, KH = 2, G = 6, hd = 128) over a 2080-key cache with kv_len 2049,
    2080 and 1, and at the deepseek, llava and musicgen decodes (G = 1 hd
    128, G = 4 hd 128, G = 1 hd 64) with kv_len 2049, each output held
    against ``decode_attention_torch``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    records = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for label, BK, G, S, hd, dtype, route, rec in (
            ("(16,6,2048,128) bf16", 16, 6, 2048, 128, bf16, "wgmma",
             "flash_attention"),
            ("(16,6,2048,64) bf16", 16, 6, 2048, 64, bf16, "wgmma", None),
            ("(16,6,2047,128) bf16 ragged", 16, 6, 2047, 128, bf16, "wgmma",
             None),
            ("(16,6,1024,128) f32", 16, 6, 1024, 128, f32, "simt",
             "flash_attention_f32"),
            ("(16,6,1024,16) bf16", 16, 6, 1024, 16, bf16, "simt", None),
            # G = 1, the MHA prefills: deepseek-moe-16b's (8 x 16 heads, hd
            # 128) and musicgen-large's (8 x 32 heads, hd 64)
            ("(128,1,2048,128) bf16 G=1", 128, 1, 2048, 128, bf16, "wgmma",
             None),
            ("(256,1,2048,64) bf16 G=1", 256, 1, 2048, 64, bf16, "wgmma",
             None),
            # G = 4, llava-next-mistral-7b's GQA prefill (8 x 8 kv heads)
            ("(64,4,2048,128) bf16 G=4", 64, 4, 2048, 128, bf16, "wgmma",
             None)):
        q = randn((BK, G, S, hd), dtype)
        k, v = randn((BK, S, hd), dtype), randn((BK, S, hd), dtype)
        flops = 4 * hd * BK * G * (S * (S + 1) // 2)
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S

        def library(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q, k[:, None], v[:, None], is_causal=True, enable_gqa=True)
        want = flash_attention_torch(q, k, v)
        err = float((library() - want).abs().max())
        check(err <= SDPA_TOL[dtype],
              f"flash {label}: SDPA is not the same function ({err})")
        K.reset_launches()
        flash_attention_grouped(q, k, v)
        check(K.ROUTES == {f"flash_attention/{route}": 1},
              f"flash {label}: routes {K.ROUTES}, expected {route}")
        r = measure(f"flash_attention {label} ({route})",
                    lambda q=q, k=k, v=v: flash_attention_grouped(q, k, v),
                    lambda q=q, k=k, v=v: flash_attention_torch(q, k, v),
                    (q, k, v), flops, hbm, peak=peak, tol=ATTN_TOL[dtype],
                    library=library)
        if rec:
            records[rec] = r
        del q, k, v, want
    B, KH, G, S, hd = 8, 2, 6, 2080, 128
    q = randn((B, KH, G, hd), bf16)
    k, v = randn((B, S, KH, hd), bf16), randn((B, S, KH, hd), bf16)
    for kv_len in (2049, 2080, 1):
        live = (k[:, :kv_len], v[:, :kv_len])

        def library(kv_len=kv_len):
            return F.scaled_dot_product_attention(
                q.reshape(B, KH * G, 1, hd), k[:, :kv_len].transpose(1, 2),
                v[:, :kv_len].transpose(1, 2), enable_gqa=True)
        want = decode_attention_torch(q, k, v, kv_len=kv_len)
        err = float((library().reshape(B, KH, G, hd) - want).abs().max())
        check(err <= SDPA_TOL[bf16],
              f"decode kv_len={kv_len}: SDPA is not the same function "
              f"({err})")
        r = measure(
            f"decode_attention (8,2,6,128) cache 2080 kv_len={kv_len} bf16",
            lambda kv_len=kv_len: decode_attention(q, k, v, kv_len=kv_len),
            lambda kv_len=kv_len: decode_attention_torch(q, k, v,
                                                         kv_len=kv_len),
            (q, *live), 4 * hd * B * KH * G * kv_len, hbm,
            peak=PEAK_BF16_FLOPS, tol=ATTN_TOL[bf16], library=library)
        if kv_len == 2049:
            records["decode_attention"] = r
    del q, k, v
    # G = 1 (deepseek-moe-16b's MHA decode, 16 kv heads), G = 4
    # (llava-next-mistral-7b's GQA decode, 8 kv heads of 4 query heads) and
    # G = 1 at hd 64 (musicgen-large's MHA decode, 32 kv heads)
    for KH, G, hd in ((16, 1, 128), (8, 4, 128), (32, 1, 64)):
        q = randn((B, KH, G, hd), bf16)
        k, v = randn((B, S, KH, hd), bf16), randn((B, S, KH, hd), bf16)
        kv_len = 2049

        def library(q=q, k=k, v=v, KH=KH, G=G, hd=hd):
            return F.scaled_dot_product_attention(
                q.reshape(B, KH * G, 1, hd), k[:, :kv_len].transpose(1, 2),
                v[:, :kv_len].transpose(1, 2), enable_gqa=True)
        want = decode_attention_torch(q, k, v, kv_len=kv_len)
        err = float((library().reshape(B, KH, G, hd) - want).abs().max())
        check(err <= SDPA_TOL[bf16],
              f"decode G={G} hd={hd}: SDPA is not the same function "
              f"({err})")
        K.reset_launches()
        decode_attention(q, k, v, kv_len=kv_len)
        torch.cuda.synchronize()
        check(K.LAUNCHES["decode_attention"] == 1
              and sum(K.LAUNCHES.values()) == 1,
              f"decode G={G} hd={hd}: launches {K.LAUNCHES}, expected one")
        measure(f"decode_attention ({B},{KH},{G},{hd}) cache {S} kv_len="
                f"{kv_len} bf16 G={G}",
                lambda q=q, k=k, v=v: decode_attention(q, k, v,
                                                       kv_len=kv_len),
                lambda q=q, k=k, v=v: decode_attention_torch(
                    q, k, v, kv_len=kv_len),
                (q, k[:, :kv_len], v[:, :kv_len]),
                4 * hd * B * KH * G * kv_len, hbm, peak=PEAK_BF16_FLOPS,
                tol=ATTN_TOL[bf16], library=library)
        del q, k, v, want
    return records


def grad_rows(gen, nb, block, dev, ties=False):
    """Gradient-like float32 rows made on the card: magnitudes spanning
    1e-12 to 1e2 by row; with ``ties``, few distinct magnitudes of both
    signs, and zeros."""
    mag = 10.0 ** (torch.rand((nb, 1), generator=gen, device=dev) * 14 - 12)
    x = torch.randn((nb, block), generator=gen, device=dev) * mag
    if ties:
        x = torch.round(x / mag * 2) / 2 * mag
        x[:, ::7] = -x[:, ::7]
        x[:, ::5] = 0.0
    return x


def held(label, got, want):
    """Check one kernel call against its plain version: 0 mismatching
    elements over every output field."""
    bad, _ = compare(tuple(want), tuple(got))
    check(bad == 0, f"{label}: {bad} mismatching elements")
    print(f"{label}: 0 mismatches", flush=True)


#: the top-k rows of qwen2-1.5b's gradient leaves, as TopKCompressor cuts
#: them: (label, nb, block, k)
TOPK_ROWS = [("gate/up/down (28,13762560) k=137625", 28, 13762560, 137625),
             ("wq/wo (28,2359296) k=23592", 28, 2359296, 23592),
             ("wk/wv (28,393216) k=3932", 28, 393216, 3932),
             ("embed (151936,1536) k=15", 151936, 1536, 15),
             ("norms/bq (28,1536) k=15", 28, 1536, 15),
             ("bk/bv (28,256) k=2", 28, 256, 2),
             ("final_norm (1,1536) k=15", 1, 1536, 15)]
#: one row of deepseek-moe-16b's expert leaves, (L, 64, 2048, 1408) cut
#: into L rows of 64 x 2048 x 1408 entries: 13x qwen2-1.5b's longest row
TOPK_MOE = [("deepseek experts (1,184549376) k=1845493", 1, 184549376,
             1845493, False)]
#: tie-heavy rows (few distinct magnitudes of both signs, and zeros):
#: (label, nb, block, k, ties)
TOPK_TIES = [("(100,70001) k=700 ties", 100, 70001, 700, True),
             ("(500,1000) k=1000 ties", 500, 1000, 1000, True)]
#: the int8 rows of qwen2-1.5b's gradient leaves: (label, nb, block)
QUANT_ROWS = [("gate/up (43008,8960)", 43008, 8960),
              ("down (250880,1536)", 250880, 1536),
              ("embed (151936,1536)", 151936, 1536),
              ("wq/wo (43008,1536)", 43008, 1536),
              ("wk/wv (43008,256)", 43008, 256),
              ("norms/bq (28,1536)", 28, 1536),
              ("bk/bv (28,256)", 28, 256),
              ("final_norm padded (2,1024)", 2, 1024)]


def compress_kernels(hbm):
    """quantize, dequantize and topk_compress at the training path's
    shapes (qwen2-1.5b's float32 gradient leaves, cut into rows as the
    compressors cut them), bitwise against their plain versions; the
    largest shape of quantize and dequantize is timed, and every top-k
    shape, with ``torch.topk`` of |x| beside it and the route it took
    (``build.ROUTES``), one row of deepseek-moe-16b's expert leaves
    among them.  Plus ties and a ragged final block."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    records = {}
    for i, (label, nb, block) in enumerate(QUANT_ROWS):
        x = grad_rows(gen, nb, block, dev)
        if i == 0:
            n = x.numel()
            q, scale = quantize_torch(x)
            records["quantize"] = measure(
                f"quantize {label} f32 +residual",
                lambda: quantize_blocks(x, residual=True),
                lambda: quantize_torch(x, residual=True), (x,), 4 * n, hbm)
            # int8 times float32 promotes to float32 (exact for int8)
            # and rounds once: the plain version's q.float() * scale
            held(f"dequantize {label} library call q * scale",
                 (q * scale,), (dequantize_torch(q, scale),))
            records["dequantize"] = measure(
                f"dequantize {label}", lambda: dequantize_blocks(q, scale),
                lambda: dequantize_torch(q, scale), (q, scale), n, hbm,
                library=lambda: q * scale)
            acc = grad_rows(gen, nb, block, dev)
            held(f"dequantize {label} accumulate",
                 (dequantize_blocks(q, scale, out=acc.clone()),),
                 (dequantize_torch(q, scale, out=acc.clone()),))
            del q, scale, acc
        else:
            held(f"quantize {label} f32 +residual",
                 quantize_blocks(x, residual=True),
                 quantize_torch(x, residual=True))
        del x
    x = grad_rows(gen, 1000, 3000, dev, ties=True)
    held("quantize (1000,3000) ties", quantize_blocks(x, residual=True),
         quantize_torch(x, residual=True))
    ragged = F.pad(x.reshape(-1)[:1536 * 1000 + 77], (0, 1024 - 77 % 1024))
    ragged = ragged.reshape(-1, 1024)
    held("quantize ragged final block", quantize_blocks(ragged, residual=True),
         quantize_torch(ragged, residual=True))
    for i, (label, nb, block, k, ties) in enumerate(
            [r + (False,) for r in TOPK_ROWS] + TOPK_MOE + TOPK_TIES):
        x = grad_rows(gen, nb, block, dev, ties=ties)
        before = dict(K.ROUTES)
        rec = measure(
            f"topk_compress {label} f32 route {topk_route(block)}",
            lambda: topk_compress_blocks(x, k),
            lambda: topk_compress_torch(x, k), (x,), x.numel(), hbm,
            library=lambda: torch.topk(x.abs(), k, dim=-1),
            plain_runs=5)
        ran = {r: n - before.get(r, 0) for r, n in K.ROUTES.items()
               if n != before.get(r, 0)}
        check(set(ran) == {f"topk_compress/{topk_route(block)}"},
              f"topk_compress {label}: routes {ran}")
        if i == 0:
            records["topk_compress"] = rec
        del x
    torch.cuda.empty_cache()
    return records


#: mamba_scan against its plain version (rtol, atol): float32 on both
#: sides, differing in the order of the sums over N and in the FMAs nvcc
#: contracts; h carries each step's rounding over about 1 / (dt |A|) steps
SCAN_TOL = (1e-4, 1e-4)


def held_close(label, got, want, tol):
    """Check one kernel call against its plain version within ``tol``
    (rtol, atol) over every output field."""
    bad, err = compare_close(tuple(want), tuple(got), *tol)
    check(bad == 0, f"{label}: {bad} elements outside rtol, atol = {tol} "
                    f"(max |difference| {err:.3g})")
    print(f"{label}: max |difference| {err:.3g} within rtol, atol = {tol}",
          flush=True)
    return err


def scan_inputs(gen, Bb, S, di, N, dev):
    """x, dt > 0, B, C, A < 0, float32, made on the card with the
    distributions of the repo's kernel test."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (randn(Bb, S, di) * 0.5, F.softplus(randn(Bb, S, di) - 1),
            randn(Bb, S, N) * 0.5, randn(Bb, S, N) * 0.5,
            -torch.exp(randn(di, N) * 0.3))


def scan_kernels(hbm):
    """mamba_scan at jamba's prefill shape, (Bb, S, di, N) = (8, 2048,
    8192, 16) float32, on its ``tma`` route (the path's) and, on the same
    inputs, its ``simt`` route (forced), both timed, with the blocks of
    each resident on an SM; and at ragged shapes: (3, 2047, 8100, 16),
    ``tma`` (S and di not multiples of the 16-step stage or the
    128-channel block), on both routes, and (3, 2047, 8102, 16), ``simt``
    (8102 % 4 != 0).  About 5 operations per (b, t, d, n), one of them an
    expf.  No PyTorch call computes the scan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    shape = (8, 2048, 8192, 16)
    for route in ("tma", "simt"):
        print(f"mamba_scan N=16 {route}: {mamba_blocks_per_sm(route, 16)} "
              f"blocks resident an SM (512 blocks on "
              f"{torch.cuda.get_device_properties(0).multi_processor_count}"
              f" SMs)", flush=True)
    args = scan_inputs(gen, *shape, dev)
    check(mamba_route(8192, 16) == "tma", "jamba's scan is not on tma")
    one_launch("mamba_scan", "(8,2048,8192,16)", lambda: mamba_scan(*args),
               "tma")
    one_launch("mamba_scan", "(8,2048,8192,16) simt",
               lambda: mamba_scan_cuda(*args, simt=True), "simt")
    ops = 5 * math.prod(shape)
    rec = measure("mamba_scan (8,2048,8192,16) f32 (tma)",
                  lambda: mamba_scan(*args), lambda: mamba_scan_torch(*args),
                  args, ops, hbm, tol=SCAN_TOL, plain_runs=2)
    simt = measure("mamba_scan (8,2048,8192,16) f32 (simt, forced)",
                   lambda: mamba_scan_cuda(*args, simt=True),
                   lambda: mamba_scan_torch(*args), args, ops, hbm,
                   tol=SCAN_TOL, plain_runs=2)
    rec["simt_ms"] = simt["ms"]
    # the training forward also saves the states every SAVED_EVERY steps
    # for the backward; the serving path (no_grad) writes none.  Both timed
    # the same way, per call between CUDA events, in turns
    hb_bytes = nbytes(mamba_scan_cuda(*args, bounds=True)[2])
    calls = {False: lambda: mamba_scan(*args),
             True: lambda: mamba_scan_cuda(*args, bounds=True)}
    turns = {False: [], True: []}
    for bounds in (False, True, True, False):
        turns[bounds].append(call_ms(calls[bounds]))
    serving, saved = turns[False], turns[True]
    print(f"mamba_scan (8,2048,8192,16) f32 (tma), per call with launch "
          f"overhead, in turns: {serving[0]:.4f} / {serving[1]:.4f} ms "
          f"without saved states (the serving path), {saved[0]:.4f} / "
          f"{saved[1]:.4f} ms saving them ({hb_bytes / 1e6:.1f} MB more "
          f"written)", flush=True)
    rec["serving_call_ms"] = min(serving)
    rec["saved_states_call_ms"] = min(saved)
    del args
    args = scan_inputs(gen, 3, 2047, 8100, 16, dev)
    want = mamba_scan_torch(*args)
    held_close("mamba_scan (3,2047,8100,16) f32 ragged (tma)",
               one_launch("mamba_scan", "(3,2047,8100,16)",
                          lambda: mamba_scan(*args), "tma"), want, SCAN_TOL)
    held_close("mamba_scan (3,2047,8100,16) f32 ragged (simt, forced)",
               mamba_scan_cuda(*args, simt=True), want, SCAN_TOL)
    del args, want
    args = scan_inputs(gen, 3, 2047, 8102, 16, dev)
    held_close("mamba_scan (3,2047,8102,16) f32 (simt)",
               one_launch("mamba_scan", "(3,2047,8102,16)",
                          lambda: mamba_scan(*args), "simt"),
               mamba_scan_torch(*args), SCAN_TOL)
    del args
    torch.cuda.empty_cache()
    return {"mamba_scan": rec}


#: mlstm_attention against its plain version (rtol, atol), as the attention
#: kernels': float32 differs only in the order of the sums (online
#: stabilizer over key tiles on the simt route); in bf16 both sides compute
#: in float32 (the wgmma route carries p in three bf16 terms, to ~2^-24)
#: and round once, so they differ by at most one bf16 ulp
MLSTM_TOL = ATTN_TOL


def mlstm_inputs(gen, B, S, H, hd, dtype, dev):
    """q, k (scaled by hd**-0.5), v in ``dtype``; F = cumsum(log_sigmoid(n
    + 3)) and I = 0.5 n float32: the model's layout (B, S, H, hd), with
    the distributions of the repo's kernel test, made on the card."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = randn(B, S, H, hd).to(dtype)
    k = (randn(B, S, H, hd) * hd ** -0.5).to(dtype)
    v = randn(B, S, H, hd).to(dtype)
    F_ = torch.cumsum(F.logsigmoid(randn(B, S, H) + 3.0), dim=1)
    return q, k, v, F_, randn(B, S, H) * 0.5


def mlstm_flops(B, S, H, hd):
    """Two chained products of hd multiply-adds over the S (S + 1) / 2
    causal (query, key) pairs of each (b, h)."""
    return 2 * 2 * hd * B * H * (S * (S + 1) // 2)


def mlstm_kernels(hbm):
    """mlstm_attention at xlstm-125m's prefill shape, (B, S, H, hd) = (8,
    2048, 4, 384) bf16 (BH = 32), on its tensor-core route (``wgmma``, the
    path's) and, on the same inputs, its CUDA-core route (``simt``,
    forced): both held against the plain version, both timed, the
    tensor-core route required faster; a float32 shape (``simt``), timed;
    and a ragged S (2047: not a multiple of the 64-row query or key tile)
    at the Pallas kernel's layout (H = 1) on both routes.  No PyTorch call
    computes this function: the library column stays empty."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    records = {}
    bf16 = torch.bfloat16
    shape = (8, 2048, 4, 384)
    args = mlstm_inputs(gen, *shape, bf16, dev)
    one_launch("mlstm_attention", "(8,2048,4,384) bf16",
               lambda: mlstm_attention(*args), "wgmma")
    one_launch("mlstm_attention", "(8,2048,4,384) bf16 simt",
               lambda: mlstm_attention_cuda(*args, simt=True), "simt")
    rec = measure("mlstm_attention (8,2048,4,384) bf16 (wgmma)",
                  lambda: mlstm_attention(*args),
                  lambda: mlstm_attention_plain(*args), args,
                  mlstm_flops(*shape), hbm, peak=PEAK_BF16_FLOPS,
                  tol=MLSTM_TOL[bf16], plain_runs=5)
    simt = measure("mlstm_attention (8,2048,4,384) bf16 (simt, forced)",
                   lambda: mlstm_attention_cuda(*args, simt=True),
                   lambda: mlstm_attention_plain(*args), args,
                   mlstm_flops(*shape), hbm, peak=PEAK_BF16_FLOPS,
                   tol=MLSTM_TOL[bf16], plain_runs=2)
    check(rec["ms"] < simt["ms"],
          f"mlstm_attention bf16: the wgmma route ({rec['ms']:.4f} ms) is "
          f"not faster than the simt route ({simt['ms']:.4f} ms)")
    rec["simt_ms"] = simt["ms"]
    records["mlstm_attention"] = rec
    del args
    shape = (2, 2048, 4, 384)
    args = mlstm_inputs(gen, *shape, torch.float32, dev)
    one_launch("mlstm_attention", "(2,2048,4,384) f32",
               lambda: mlstm_attention(*args), "simt")
    records["mlstm_attention_f32"] = measure(
        "mlstm_attention (2,2048,4,384) f32 (simt)",
        lambda: mlstm_attention(*args),
        lambda: mlstm_attention_plain(*args), args, mlstm_flops(*shape),
        hbm, peak=PEAK_OPS_PER_S, tol=MLSTM_TOL[torch.float32],
        plain_runs=5)
    del args
    args = mlstm_inputs(gen, 6, 2047, 1, 384, bf16, dev)
    want = mlstm_attention_plain(*args)
    held_close("mlstm_attention (6,2047,1,384) bf16 ragged (wgmma)",
               one_launch("mlstm_attention", "(6,2047,1,384) bf16",
                          lambda: mlstm_attention(*args), "wgmma"),
               want, MLSTM_TOL[bf16])
    held_close("mlstm_attention (6,2047,1,384) bf16 ragged (simt, forced)",
               mlstm_attention_cuda(*args, simt=True), want,
               MLSTM_TOL[bf16])
    del args, want
    torch.cuda.empty_cache()
    return records


#: the backward kernels against their plain versions, as a share of each
#: gradient's largest magnitude (``compare_scaled``): float32 on both sides
#: in other orders (the scan's sums over d and n are shuffles and
#: per-block partials, dA a sum over 8192 batch-steps; the mLSTM's
#: products run key tile by key tile); in bf16, dq, dk and dv are rounded
#: once to bf16 on both sides, a relative 2^-8 each
SCAN_BWD_TOL = 1e-4
MLSTM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def scan_bwd_inputs(gen, Bb, S, di, N, dev):
    """``scan_inputs`` plus the output gradients dy (Bb, S, di) and
    dh_final (Bb, di, N)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (*scan_inputs(gen, Bb, S, di, N, dev), randn(Bb, S, di),
            randn(Bb, di, N))


def scan_backward_kernels(hbm):
    """mamba_scan_backward at jamba's training shape, (Bb, S, di, N) = (4,
    2048, 8192, 16) float32, with dh_final = None as training has it and
    the forward's saved states (``mamba_scan_cuda(..., bounds=True)``, as
    the training forward writes them): held against the plain backward,
    timed, and run twice for bitwise equal gradients; timed again without
    saved states (the wrapper runs the forward for them first); then at
    odd shapes: S = 2047 (not a multiple of the 16-step chunk) with di =
    8102 (di % 4 != 0) and a nonzero dh_final, and N = 4, 8, 32.  The
    bound: every input of the function read and every gradient written
    once (x, dt, dy, dx and ddt are 268 MB each; B, C, A and theirs are
    small; the saved states are the design's, not the function's), about
    14 operations per (b, t, d, n).  No PyTorch call computes this
    gradient."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2029)
    shape = (4, 2048, 8192, 16)
    args = scan_bwd_inputs(gen, *shape, dev)[:6]
    hb = mamba_scan_cuda(*args[:5], bounds=True)[2]
    got = one_launch("mamba_scan_backward", "(4,2048,8192,16)",
                     lambda: mamba_scan_backward(*args, None, hb), None)
    again = mamba_scan_backward(*args, None, hb)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "mamba_scan_backward: two runs on the same inputs differ")
    print("mamba_scan_backward (4,2048,8192,16): two runs bitwise equal",
          flush=True)
    del got, again
    rec = measure("mamba_scan_backward (4,2048,8192,16) f32 (saved states)",
                  lambda: mamba_scan_backward(*args, None, hb),
                  lambda: mamba_scan_backward_torch(*args), args,
                  14 * math.prod(shape), hbm, scaled=SCAN_BWD_TOL,
                  plain_runs=1)
    whole, whole_by = device_ms(lambda: mamba_scan_backward(*args))
    print(f"mamba_scan_backward (4,2048,8192,16) without saved states (the "
          f"forward for them, then the backward): {whole:.4f} ms "
          f"({whole_by}); saved states {nbytes(hb) / 1e6:.1f} MB, the dB / "
          f"dC partials "
          f"{2 * 4 * (shape[0] * -(-shape[2] // 128) * shape[1] * shape[3]) / 1e6:.1f}"
          f" MB", flush=True)
    rec["without_saved_ms"] = whole
    del args, hb
    torch.cuda.empty_cache()
    for shape in ((3, 2047, 8102, 16), (2, 300, 1000, 4), (2, 300, 999, 8),
                  (2, 300, 1001, 32)):
        args = scan_bwd_inputs(gen, *shape, dev)
        hb = mamba_scan_cuda(*args[:5], bounds=True)[2]
        got = one_launch("mamba_scan_backward", str(shape),
                         lambda: mamba_scan_backward(*args, hb), None)
        again = mamba_scan_backward(*args, hb)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"mamba_scan_backward {shape}: two runs differ")
        want = mamba_scan_backward_torch(*args)
        bad, err = compare_scaled(want, got, SCAN_BWD_TOL)
        check(bad == 0, f"mamba_scan_backward {shape}: {bad} elements "
                        f"outside {SCAN_BWD_TOL} (max |difference| {err:.3g})")
        print(f"mamba_scan_backward {shape} f32 with dh_final: max "
              f"|difference| {err:.3g} within {SCAN_BWD_TOL} of each "
              f"gradient's largest magnitude; two runs bitwise equal",
              flush=True)
        del args, got, again, want, hb
    torch.cuda.empty_cache()
    return {"mamba_scan_backward": rec}


def mlstm_backward_inputs(gen, B, S, H, hd, dtype, dev):
    """``mlstm_inputs`` plus the output gradient dh in ``dtype``; every
    7th input gate is -6, so some rows take den's exp(-m) branch."""
    q, k, v, F_, I = mlstm_inputs(gen, B, S, H, hd, dtype, dev)
    I[:, ::7] = -6.0
    dh = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, F_, I, dh


def mlstm_backward_kernels(hbm):
    """mlstm_attention_backward at xlstm-125m's training shape, (B, S, H,
    hd) = (4, 2048, 4, 384) bf16 (BH = 16), on its tensor-core route
    (``wgmma``, the path's) and, on the same inputs, its CUDA-core route
    (``simt``, forced): both held against the plain backward and timed,
    two runs of the path's route bitwise equal, the tensor-core route
    required faster than the plain version; a float32 shape (``simt``, the
    float32 phases' route), timed; then hd 64, 128, 256 and 384 in bf16
    and float32 at a ragged S (2047, not a multiple of the 32- or 64-row
    tiles), each call's route read from ``build.ROUTES`` and run twice for
    bitwise equal gradients.  The bound counts the five causal products
    the function needs (q k^T, dh v^T, dq, dk, dv) at the bf16
    tensor-core peak (float32 FMA for float32).  No PyTorch call computes
    this gradient."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2030)
    bf16, f32 = torch.bfloat16, torch.float32
    records = {}
    shape = (4, 2048, 4, 384)
    args = mlstm_backward_inputs(gen, *shape, bf16, dev)
    check(mlstm_route(bf16, 384) == "wgmma",
          "xlstm-125m's mLSTM backward is not on wgmma")
    got = one_launch("mlstm_attention_backward", "(4,2048,4,384) bf16",
                     lambda: mlstm_attention_backward(*args), "wgmma")
    again = mlstm_attention_backward(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "mlstm_attention_backward (wgmma): two runs on the same inputs "
          "differ")
    del got, again
    one_launch("mlstm_attention_backward", "(4,2048,4,384) bf16 simt",
               lambda: mlstm_attention_backward_cuda(*args, simt=True),
               "simt")
    flops = 5 * mlstm_flops(*shape) // 2
    rec = measure("mlstm_attention_backward (4,2048,4,384) bf16 (wgmma)",
                  lambda: mlstm_attention_backward(*args),
                  lambda: mlstm_attention_backward_plain(*args), args,
                  flops, hbm, peak=PEAK_BF16_FLOPS,
                  scaled=MLSTM_BWD_TOL[bf16], plain_runs=2)
    simt = measure("mlstm_attention_backward (4,2048,4,384) bf16 (simt, "
                   "forced)",
                   lambda: mlstm_attention_backward_cuda(*args, simt=True),
                   lambda: mlstm_attention_backward_plain(*args), args,
                   flops, hbm, peak=PEAK_BF16_FLOPS,
                   scaled=MLSTM_BWD_TOL[bf16], plain_runs=2)
    check(rec["ms"] < rec["plain_ms"],
          f"mlstm_attention_backward bf16: the wgmma route "
          f"({rec['ms']:.4f} ms) is not below its plain version "
          f"({rec['plain_ms']:.4f} ms)")
    rec["simt_ms"] = simt["ms"]
    records["mlstm_attention_backward"] = rec
    del args
    shape = (1, 2048, 4, 384)
    args = mlstm_backward_inputs(gen, *shape, f32, dev)
    one_launch("mlstm_attention_backward", "(1,2048,4,384) f32",
               lambda: mlstm_attention_backward(*args), "simt")
    records["mlstm_attention_backward_f32"] = measure(
        "mlstm_attention_backward (1,2048,4,384) f32 (simt)",
        lambda: mlstm_attention_backward(*args),
        lambda: mlstm_attention_backward_plain(*args), args,
        5 * mlstm_flops(*shape) // 2, hbm, peak=PEAK_OPS_PER_S,
        scaled=MLSTM_BWD_TOL[f32], plain_runs=2)
    del args
    for hd in (64, 128, 256, 384):
        for dtype in (bf16, f32):
            args = mlstm_backward_inputs(gen, 1, 2047, 2, hd, dtype, dev)
            route = mlstm_route(dtype, hd)
            got = one_launch("mlstm_attention_backward", f"hd {hd}",
                             lambda: mlstm_attention_backward(*args), route)
            again = mlstm_attention_backward(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"mlstm_attention_backward (1,2047,2,{hd}) {dtype}: two "
                  f"runs differ")
            want = mlstm_attention_backward_plain(*args)
            tol = MLSTM_BWD_TOL[dtype]
            bad, err = compare_scaled(want, got, tol)
            check(bad == 0, f"mlstm_attention_backward (1,2047,2,{hd}) "
                            f"{dtype}: {bad} elements outside {tol} (max "
                            f"|difference| {err:.3g})")
            print(f"mlstm_attention_backward (1,2047,2,{hd}) {dtype} "
                  f"({route}): max |difference| {err:.3g} within {tol} of "
                  f"each gradient's largest magnitude; two runs bitwise "
                  f"equal", flush=True)
            del args, got, again, want
    torch.cuda.empty_cache()
    return records


@phase("kernels")
def kernels(hbm):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    records = {}
    # duct_window (label, n, d, C, L, max_pops, payload): torus-4096 buckets
    # at L = 1 (graph coloring's shape) and L = 8, a degree-8 bucket, and
    # evo's torus-1024 float32 halos (3600 cells, L = 60)
    for label, n, d, C, L, pops, pay, rec in (
            ("torus4096-L1", 4096, 4, 64, 1, 16, np.int32, "duct_window"),
            ("torus4096-L8", 4096, 4, 64, 8, 16, np.int32, None),
            ("deg8-L1", 2048, 8, 64, 1, 16, np.int32, None),
            ("evo-torus1024-L60-f32", 1024, 4, 64, 60, 16, np.float32,
             "duct_window_f32")):
        args = window_state(rng, n, d, C, L, 64, dev, pay)
        r = measure(f"duct_window {label}",
                    lambda: duct_window(*args, max_pops=pops),
                    lambda: duct_window_torch(*args, max_pops=pops),
                    args, n * d * C * (8 + 2 * L), hbm)
        if rec:
            records[rec] = r
    # duct_commit (label, R, C, L, W, payload): torus-4096 rings at W = 8,
    # L = 1 and 8, and evo's torus-1024 float32 rings
    for label, R, C, L, W, pay, rec in (
            ("R16384-W8", 16384, 64, 1, 8, np.int32, "duct_commit"),
            ("R16384-W8-L8", 16384, 64, 8, 8, np.int32, None),
            ("evo-R4096-W8-L60-f32", 4096, 64, 60, 8, np.float32,
             "duct_commit_f32")):
        args = commit_state(rng, R, C, L, W, dev, pay)
        r = measure(f"duct_commit {label}", lambda: duct_commit(*args),
                    lambda: duct_commit_torch(*args), args,
                    R * C * (6 + L), hbm, read=commit_read(args))
        if rec:
            records[rec] = r
        if rec == "duct_commit_f32":
            check(r["ms"] < r["plain_ms"],
                  f"duct_commit {label}: kernel {r['ms']:.4f} ms is not "
                  f"below its plain version's {r['plain_ms']:.4f} ms")
    # duct_exchange at the torus-4096 edge layout (E = 16384, C = 64): the
    # fused form, and the two forms the edge-major window launches
    E, C, pops = 16384, 64, 16
    args = exchange_state(rng, E, C, dev)
    ops = E * C * 10
    records["duct_exchange"] = measure(
        "duct_exchange E16384-C64 full",
        lambda: duct_exchange(*args, capacity=C, max_pops=pops),
        lambda: duct_exchange_torch(*args, capacity=C, max_pops=pops),
        args, ops, hbm)
    one_launch("duct_exchange", "full",
               lambda: duct_exchange(*args, capacity=C, max_pops=pops),
               "full")
    # the entry points the edge-major window launches, each on its own
    # route; each bound counts the work that function must do
    one_launch("duct_exchange", "drain",
               lambda: duct_drain(*args[:6], max_pops=pops), "drain")
    one_launch("duct_exchange", "send",
               lambda: duct_send(*args[:4], *args[6:], capacity=C), "send")
    records["duct_exchange_drain"] = measure(
        "duct_exchange E16384-C64 drain",
        lambda: duct_drain(*args[:6], max_pops=pops),
        lambda: duct_drain_torch(*args[:6], max_pops=pops),
        args[:6], ops, hbm, **drain_bytes(args, pops))
    records["duct_exchange_send"] = measure(
        "duct_exchange E16384-C64 send",
        lambda: duct_send(*args[:4], *args[6:], capacity=C),
        lambda: duct_send_torch(*args[:4], *args[6:], capacity=C),
        args[:4] + args[6:], ops, hbm)
    records.update(attention_kernels(hbm))
    records.update(compress_kernels(hbm))
    records.update(scan_kernels(hbm))
    records.update(mlstm_kernels(hbm))
    records.update(scan_backward_kernels(hbm))
    records.update(mlstm_backward_kernels(hbm))
    return records


# ---------------------------------------------------------------------------
# 4. oracle on the card
# ---------------------------------------------------------------------------
def case_seed(topology: str, seed: int = 0) -> int:
    return ((zlib.crc32(topology.encode("ascii")) & 0x7F) << 8) | (seed & 0xFF)


def gc_app(n, topology, seed, simels=1):
    return GraphColorApp(
        GraphColorConfig(n_processes=n, nodes_per_process=simels, seed=seed),
        topology=make_topology(topology, n))


def dyadic_cfg(**kw):
    return SimConfig(**{**DYADIC, **kw})


#: phase 4's dyadic 16-process scenarios: (name, topology, mode, fault
#: model of the topology or None, quarantine timeout)
ORACLE_SCENARIOS = (
    ("torus-best-effort", "torus", AsyncMode.BEST_EFFORT, None, 0.0),
    ("ring-barrier-victim-fault", "ring", AsyncMode.BARRIER_EVERY_STEP,
     lambda t: FaultModel(compute_slowdown={1: 8.0}), 0.0),
    ("cliques-best-effort-lossy", "cliques", AsyncMode.BEST_EFFORT,
     lambda t: lossy_host(t, 0, 0.25), 0.0),
    ("torus-fixed-crash-quarantine", "torus", AsyncMode.FIXED_BARRIER,
     lambda t: crashed_host(t, 0), QUARANTINE_TAU),
)


#: the oracle runs' horizon: half the dyadic configs' 2**-7 (cut for the
#: script's time limit)
ORACLE_DURATION = 2.0 ** -8


def oracle_on_card(layouts=("dense", "edge"), **kw):
    """Phase 4's scenarios on ``layouts`` on the card (``kw``: more
    RunConfig fields): each ``qos_signature`` must be the event
    simulator's, quality excluded."""
    for name, topology, mode, fault, tau in ORACLE_SCENARIOS:
        seed = case_seed(topology)
        cfg = dyadic_cfg(mode=mode, seed=seed, barrier_timeout=tau,
                         duration=ORACLE_DURATION)

        def faults():
            return fault(make_topology(topology, 16)) if fault else None

        want = qos_signature(make_engine(
            "event", gc_app(16, topology, seed), cfg, faults()).run())
        want.pop("quality")
        for layout in layouts:
            got = qos_signature(make_engine(
                RunConfig(engine="torch", layout=layout, **kw),
                gc_app(16, topology, seed), cfg, faults(),
                max_pops=EXACT_MAX_POPS, chunk=64, device="cuda").run())
            got.pop("quality")
            check(got == want, f"{name}: torch {layout} {json.dumps(kw)} "
                  "on the card != event oracle")
            check(sum(got["updates"]) > 0, f"{name}: no updates")
            print(f"{name} {layout} {json.dumps(kw)}: qos_signature == "
                  f"event oracle ({sum(got['updates'])} updates, "
                  f"{got['sent']} sent)", flush=True)


@phase("oracle")
def oracle():
    oracle_on_card()


# ---------------------------------------------------------------------------
# 5. end to end, card vs CPU
# ---------------------------------------------------------------------------
#: the card = CPU runs' horizon: a quarter of the dyadic configs' 2**-7
#: (cut for the script's time limit; ~130 windows a run)
CARD_CPU_DURATION = 2.0 ** -9


@phase("card_vs_cpu")
def card_vs_cpu():
    card_equals_cpu([("graphcolor", "torus", 1024, 64, {}),
                     ("graphcolor", "smallworld", 1024, 1, {}),
                     ("graphcolor", "torus", 1024, 1, {"layout": "edge"}),
                     ("evo", "torus", 64, 64, {}),
                     ("evo", "torus", 64, 64, {"superstep_windows": 4}),
                     ("evo", "torus", 64, 64, {"layout": "edge"})])


def card_equals_cpu(cases):
    """Each (app, topology, n, simels, RunConfig fields) case, dyadic, on
    the card (kernels) and on the CPU (plain versions): equal SimResults,
    quality included."""
    for app_name, topology, n, simels, kw in cases:
        seed = case_seed(topology)
        cfg = dyadic_cfg(seed=seed, duration=CARD_CPU_DURATION)
        label = (f"{app_name} {topology}-{n} simels={simels} "
                 f"{json.dumps(kw)}")
        sig = {}
        for device in ("cuda", "cpu"):
            K.reset_launches()
            t0 = time.perf_counter()
            res = make_engine(RunConfig(engine="torch", **kw),
                              experiments.make_app(app_name, n, simels,
                                                   make_topology(topology, n),
                                                   seed),
                              cfg, chunk=64, device=device).run()
            dt = time.perf_counter() - t0
            sig[device] = qos_signature(res)
            launched = sum(K.LAUNCHES.values())
            check((launched > 0) == (device == "cuda"),
                  f"{label} on {device}: {launched} kernel launches")
            print(f"{label} {device}: {sum(res.updates)} updates, quality "
                  f"{res.quality}, {dt:.1f}s wall, {launched} kernel "
                  f"launches", flush=True)
        check(sig["cuda"] == sig["cpu"],
              f"{label}: card and CPU SimResults differ")
        print(f"{label}: card == CPU (full SimResult incl. quality)")


# ---------------------------------------------------------------------------
# 6. full size: the paper's experiments at full width
# ---------------------------------------------------------------------------
#: each ``drive`` run's windows, wall s, updates and duct launches, by label
DRIVEN = {}


def drive_engine(app_name, n, simels, duration, kw, chunk=256,
                 mode=AsyncMode.BEST_EFFORT, group=None):
    """The engine of one main-path run through the CLI's configuration
    (torus, buffer 64, best effort unless ``mode`` says otherwise), its
    shards split over the ranks of ``group`` where given."""
    argv = ["--engine", "torch", "--device", "cuda", "--topology", "torus",
            "--procs", str(n), "--simels", str(simels), "--buffer", "64",
            "--duration", str(duration)]
    args = experiments.build_parser().parse_args(argv)
    cfg = experiments._sim_config(args, n, mode=mode)
    extra = {} if group is None else {"group": group}
    return make_engine(RunConfig(engine="torch", **kw),
                       experiments.make_app(app_name, n, simels,
                                            make_topology("torus", n),
                                            args.seed), cfg,
                       chunk=chunk, device="cuda", **extra), args.seed


def drive(label, app_name, n, simels, duration, kw, chunk=256,
          mode=AsyncMode.BEST_EFFORT):
    """One main-path run through the CLI's configuration, with the launch
    counters set to 0 just before it and read just after it."""
    eng, _ = drive_engine(app_name, n, simels, duration, kw, chunk, mode)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = dict(K.LAUNCHES), dict(K.ROUTES)
    updates = sum(res.updates)
    windows = eng.windows[-1]
    dist = aggregate_reports(res.qos)
    med = {m: dist[m]["median"] for m in dist}
    print(f"full size {label}: {updates} updates, {updates / wall:.0f} "
          f"updates/s, {wall:.2f}s wall, {windows} windows "
          f"({wall * 1e3 / windows:.3f} ms/window), delivery failure rate "
          f"{res.delivery_failure_rate:.4f}, quality {res.quality}, "
          f"launches {launches}, routes {routes}", flush=True)
    print(f"full size {label} QoS medians: {json.dumps(med)}", flush=True)
    DRIVEN[label] = dict(windows=windows, wall=wall, updates=updates,
                         launches=launches)
    if label in RANK_HELD:
        DRIVEN[label]["result"] = res
    return res, windows, launches, routes


@phase("full_size")
def full_size():
    """Graph coloring at the headline scale on both layouts and both
    schedulers, then evo at the paper's 3600 cells per process.  Returns
    each kernel entry's launch count from its main path."""
    # (label, app, n, simels, duration, run kwargs, chunk, kernel the
    # path must launch)
    paths = [
        ("graphcolor torus-4096 window", "graphcolor", 4096, 1, 0.02, {},
         256, "duct_window"),
        ("graphcolor torus-4096 superstep8", "graphcolor", 4096, 1, 0.02,
         {"superstep_windows": 8}, 256, "duct_commit"),
        ("graphcolor torus-4096 edge", "graphcolor", 4096, 1, 0.02,
         {"layout": "edge"}, 256, "duct_exchange"),
        # evo cut to 0.0025 virtual s (about 150 updates per process) and
        # probed every 64 windows: a window costs tens of ms here
        ("evo torus-1024 3600 cells window", "evo", 1024, 3600, 0.0025, {},
         64, "duct_window"),
        ("evo torus-1024 3600 cells superstep8", "evo", 1024, 3600, 0.0025,
         {"superstep_windows": 8}, 64, "duct_commit"),
        ("evo torus-1024 3600 cells edge", "evo", 1024, 3600, 0.0025,
         {"layout": "edge"}, 64, "duct_exchange"),
    ]
    sigs, launched = {}, {}
    for label, app_name, n, simels, duration, kw, chunk, used in paths:
        res, windows, launches, routes = drive(label, app_name, n, simels,
                                               duration, kw, chunk)
        check(launches[used] > 0, f"{label}: {used} never launched")
        if used == "duct_exchange":
            # the edge-major window drains and sends with one launch each,
            # each through its own entry point
            check(launches[used] == 2 * windows,
                  f"{label}: {launches[used]} duct_exchange launches in "
                  f"{windows} windows")
            check(routes == {"duct_exchange/drain": windows,
                             "duct_exchange/send": windows},
                  f"{label}: routes {routes} in {windows} windows")
            # each record gets its own route's count: the fused form
            # (record "duct_exchange") is not on this path
            for route in ("drain", "send", "full"):
                launched.setdefault(
                    "duct_exchange" + ("" if route == "full"
                                       else f"_{route}"),
                    routes.get(f"duct_exchange/{route}", 0))
        else:
            # evo's halos are float32: its launches are the f32 entry points
            entry = used + ("_f32" if app_name == "evo" else "")
            launched.setdefault(entry, launches[used])
        sigs[label] = qos_signature(res)
    for app_name, base in (("graphcolor", "graphcolor torus-4096"),
                           ("evo", "evo torus-1024 3600 cells")):
        want = sigs[f"{base} window"]
        for other in ("superstep8", "edge"):
            got = sigs[f"{base} {other}"]
            check(got["updates"] == want["updates"],
                  f"{base}: {other} updates differ from per-window")
            check(got == want,
                  f"{base}: {other} SimResult differs from per-window")
        print(f"{base}: per-window == superstep8 == edge (full SimResult "
              f"incl. quality)", flush=True)
    return launched, sigs


# ---------------------------------------------------------------------------
# 7. the dense LM, card vs CPU, on the reduced configs
# ---------------------------------------------------------------------------
#: float32 logits, card against CPU: only the order of the sums differs
LM_F32_TOL = 1e-4
#: bf16 logits, card against CPU, as a share of the largest logit: the
#: card's bf16 products (cuBLAS) round in other places than the CPU's
LM_BF16_REL = 5e-2
#: jamba in bf16 is held on what is continuous in its inputs.  Its MoE
#: router picks the top 2 experts, so a bf16 rounding that moves a router
#: logit across a near tie sends the token to another expert: on the CPU,
#: raising 30% of layer 0's in_proj entries by one bf16 ulp moves the
#: reduced jamba's logits by more than 20% of the largest, and under 10%
#: with MLPs in place of its MoE layers (tests/test_torch_hybrid_lm.py::
#: test_bf16_routing_makes_the_logits_discontinuous).  So in bf16 the
#: card is held to the CPU on
#: the caches of the layers up to the first MoE (the Mamba states that no
#: routing decision reaches) and on the MoE alone given the same inputs,
#: both within JAMBA_BF16_REL of the largest magnitude (two bf16 ulps of
#: it, and the states carry such differences through 64 + 7 steps); the
#: logits are printed, not held
JAMBA_BF16_REL = 5e-2


def moe_card_vs_cpu(cpu, card, cfg, B, P):
    """The first MoE layer of a reduced config (jamba, deepseek-moe-16b,
    dbrx-132b) on the same bf16 inputs on both devices, over a sequence
    (grouped, with capacity drops) and one token (dense): the same experts
    for every token, outputs within JAMBA_BF16_REL of the largest
    magnitude."""
    layer = next(i for i, b in enumerate(cpu.stack.blocks)
                 if b.spec[1] == "moe")
    pc = layers.leaves(cpu.stack.blocks[layer].ffn)
    pg = layers.leaves(card.stack.blocks[layer].ffn)
    gen = torch.Generator().manual_seed(3)
    for S in (P, 1):
        x = torch.randn((B, S, cfg.d_model), generator=gen).to(torch.bfloat16)
        check(torch.equal(moe._route(pc, x, cfg)[2],
                          moe._route(pg, x.cuda(), cfg)[2].cpu()),
              f"{cfg.name} bf16 MoE S={S}: the card routes differently")
        want = moe.apply_moe(pc, x, cfg)[0].float()
        got = moe.apply_moe(pg, x.cuda(), cfg)[0].float().cpu()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= JAMBA_BF16_REL * scale,
              f"{cfg.name} bf16 MoE S={S}: differs by {err} (largest "
              f"{scale})")
        print(f"{cfg.name} bf16 MoE layer {layer}, S={S}: same experts, max "
              f"|difference| {err:.3g} of largest {scale:.3g}", flush=True)


def upstream_caches_agree(label, got, want, cfg):
    """The caches of the layers up to the first MoE layer (each its
    mixer's, computed before any routing), card against CPU, within
    JAMBA_BF16_REL of each cache's largest magnitude."""
    first_moe = next(i for i, s in enumerate(transformer.block_specs(cfg))
                     if s[1] == "moe")
    worst = 0.0
    for i in range(first_moe + 1):
        for name, w in want[i].items():
            w = w.float()
            err = float((got[i][name].float().cpu() - w).abs().max())
            scale = float(w.abs().max())
            check(err <= JAMBA_BF16_REL * scale,
                  f"{label}: layer {i} {name} differs by {err} (largest "
                  f"{scale})")
            worst = max(worst, err / scale)
    return worst


def expected_launches(cfg, decode_steps):
    """The launches of one prefill and ``decode_steps`` decode steps of
    ``cfg``: one ``flash_attention`` per attention layer, one
    ``decode_attention`` per attention layer and step, one ``mamba_scan``
    per Mamba layer, one ``mlstm_attention`` per mLSTM layer, no other
    kernel (the sLSTM and every decode step of a recurrent layer are plain
    torch)."""
    specs = transformer.block_specs(cfg)
    mixers = [specs[i % len(specs)][0] for i in range(cfg.num_layers)]
    want = {n: 0 for n in K.LAUNCHES}
    want["flash_attention"] = mixers.count("attn")
    want["decode_attention"] = mixers.count("attn") * decode_steps
    want["mamba_scan"] = mixers.count("mamba")
    want["mlstm_attention"] = mixers.count("mlstm")
    return want


def smoke_card_vs_cpu(arch, dtype, B=4, P=64, T=8):
    """One reduced config (``reduce_for_smoke``) in ``dtype`` from the same
    seeded weights on both devices: the CPU serves greedily (plain
    versions), the card replays the CPU's tokens (teacher forcing) through
    the kernels; a config with a frontend takes the same seeded prefix on
    both.  Logits agree at every step and, in float32, the card's greedy
    tokens are the CPU's; an MoE config in bf16 is held on its caches up
    to the first MoE layer and on that MoE layer alone (JAMBA_BF16_REL
    says why).  Exact launch counts and routes.  Returns the card's
    flash launches."""
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
    cpu = lm.cast_params_for_compute(lm.LM(cfg, seed=0, device="cpu"))
    card = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            dtype=torch.int32)
    fe = serve.frontend_prefix(cfg, B, 0, "cpu")
    fe_card = fe.cuda() if fe is not None else None
    K.reset_launches()
    want = serve.serve(cpu, prompts, T, fe)
    check(sum(K.LAUNCHES.values()) == 0,
          f"{arch}: the CPU run launched kernels")
    held = cfg.num_experts > 0 and dtype == "bfloat16"
    if held:    # the CPU's caches, teacher-forced as the card's
        _, cpu_caches = lm.prefill_step(cpu, prompts, P + T, fe)
        cpu_prefill = [{n: t.clone() for n, t in c.items()}
                       for c in cpu_caches]
        for i in range(T - 1):
            lm.decode_step(cpu, want.seqs[:, i:i + 1], cpu_caches, P + i)
    K.reset_launches()
    logits, caches = lm.prefill_step(card, prompts.cuda(), P + T, fe_card)
    if held:
        worst = upstream_caches_agree(
            f"{arch} bf16 prefill", caches, cpu_prefill, cfg)
    got = [logits[:, -1]]
    for i in range(T - 1):
        tok = want.seqs[:, i:i + 1].cuda()
        nxt, logits, caches = lm.decode_step(card, tok, caches, P + i)
        got.append(logits[:, -1])
        if dtype == "float32":
            check(torch.equal(nxt.cpu()[:, 0], want.seqs[:, i + 1]),
                  f"{arch}: greedy token {i + 1} differs on the card")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches == expected_launches(cfg, T - 1),
          f"{arch} {dtype}: launches {launches}")
    n_flash = launches["flash_attention"]
    n_mlstm = launches["mlstm_attention"]
    routes = {r: n for r, n in K.ROUTES.items()
              if r.startswith("flash_attention/")}
    check(routes == ({"flash_attention/simt": n_flash} if n_flash else {}),
          f"{arch} {dtype}: flash routes {routes} (hd {cfg.hd}: the "
          f"CUDA-core route)")
    routes = {r: n for r, n in K.ROUTES.items()
              if r.startswith("mlstm_attention/")}
    check(routes == ({"mlstm_attention/simt": n_mlstm} if n_mlstm else {}),
          f"{arch} {dtype}: mlstm routes {routes} (float32: the CUDA-core "
          f"route)")
    n_scan = launches["mamba_scan"]
    scan_route = mamba_route(cfg.mamba_expand * cfg.d_model,
                             cfg.mamba_d_state)
    routes = {r: n for r, n in K.ROUTES.items()
              if r.startswith("mamba_scan/")}
    check(routes == ({f"mamba_scan/{scan_route}": n_scan} if n_scan else {}),
          f"{arch} {dtype}: scan routes {routes}, expected {scan_route}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{arch} {dtype}: non-finite logits on the card")
    # stacked, so that a NaN at any step makes the max NaN
    err = float(torch.stack([(g.cpu() - w).abs().max()
                             for g, w in zip(got, want.logits)]).max())
    scale = float(torch.stack([w.abs().max() for w in want.logits]).max())
    if dtype == "float32":
        check(err <= LM_F32_TOL, f"{arch}: card logits differ by {err}")
    elif held:
        worst = max(worst, upstream_caches_agree(
            f"{arch} bf16 after {T - 1} steps", caches, cpu_caches, cfg))
        print(f"{cfg.name} bf16: caches up to the first MoE layer agree "
              f"within {worst:.3g} of their largest values after prefill "
              f"and after {T - 1} steps (logits, not held: max |difference| "
              f"{err:.3g} of largest {scale:.3g})", flush=True)
        moe_card_vs_cpu(cpu, card, cfg, B, P)
    else:
        check(err <= LM_BF16_REL * scale,
              f"{arch} bf16: card logits differ by {err} (largest logit "
              f"{scale})")
    print(f"{cfg.name} {dtype}: {T} steps"
          + (f", a {cfg.frontend_len}-position {cfg.frontend} prefix"
             if fe is not None else "")
          + f", launches flash {launches['flash_attention']} decode "
          f"{launches['decode_attention']} mamba_scan "
          f"{launches['mamba_scan']} mlstm_attention "
          f"{launches['mlstm_attention']}" + ("" if held else
          f"; card == CPU (max |logit difference| {err:.3g}, largest logit "
          f"{scale:.3g})"), flush=True)
    return n_flash


@phase("lm_card_vs_cpu")
def lm_card_vs_cpu():
    """The reduced qwen2-1.5b (QKV bias) and qwen3-0.6b (qk_norm), 2
    layers, jamba-v0.1-52b (Mamba, attention, MoE; one 8-layer period)
    and xlstm-125m (mLSTM, sLSTM; 6 layers, float32), each through
    ``smoke_card_vs_cpu``.  Returns the float32 flash launches (all on the
    CUDA-core route, hd 16)."""
    f32_flash = 0
    for arch, dtypes in (("qwen2-1.5b", ("float32", "bfloat16")),
                         ("qwen3-0.6b", ("float32", "bfloat16")),
                         ("jamba-v0.1-52b", ("float32", "bfloat16")),
                         ("xlstm-125m", ("float32",))):
        for dtype in dtypes:
            n_flash = smoke_card_vs_cpu(arch, dtype)
            if dtype == "float32":
                f32_flash += n_flash
    return {"flash_attention_f32": f32_flash}


# ---------------------------------------------------------------------------
# 8. the dense LM at full width: qwen2-1.5b serving 8 x (2048 + 32)
# ---------------------------------------------------------------------------
#: prefill of prompt + k tokens against decode step k, bf16, as a share of
#: the largest logit: two different kernels and cuBLAS shapes round the
#: 28 layers' bf16 products in different places
CROSS_REL = 5e-2


def cross_check(label, model, prompts, res, rel, frontend=None):
    """The logits of a prefill of the prompt plus k generated tokens (with
    ``frontend``, the prefix the serve took, where it took one) against decode
    step k's (k = 1 and the last), within ``rel`` of the largest logit."""
    T = res.seqs.shape[1]
    for k in (1, T - 1):
        full = torch.cat([prompts, res.seqs[:, :k]], dim=1)
        logits, _ = lm.prefill_step(model, full,
                                    frontend_embeds=frontend)
        want = res.logits[k]
        err = float((logits[:, -1] - want).abs().max())
        scale = float(want.abs().max())
        same = float((logits[:, -1].argmax(-1) == want.argmax(-1))
                     .float().mean())
        check(err <= rel * scale,
              f"{label}: prefill of prompt + {k} tokens vs decode step {k}: "
              f"logits differ by {err} (largest {scale})")
        print(f"{label} prefill {full.shape[1]} tokens vs decode step {k}: "
              f"max |logit difference| {err:.4g} of largest {scale:.4g}, "
              f"greedy tokens agree on {same:.3f} of the batch", flush=True)


@phase("lm_full_size")
def lm_full_size():
    """qwen2-1.5b at full width through the serving entry point, launch
    counters zeroed just before it and read just after it.  Returns each
    attention kernel's launches on that path."""
    argv = ["--arch", "qwen2-1.5b", "--batch", "8", "--prompt-len", "2048",
            "--tokens", "32", "--device", "cuda", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    model, prompts, _, res = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    L, T = cfg.num_layers, res.seqs.shape[1]
    check(launches["flash_attention"] == L,
          f"qwen2-1.5b: {launches['flash_attention']} flash launches, "
          f"expected {L}")
    check(launches["decode_attention"] == L * (T - 1),
          f"qwen2-1.5b: {launches['decode_attention']} decode launches, "
          f"expected {L} x {T - 1}")
    check(K.ROUTES == {"flash_attention/wgmma": L},
          f"qwen2-1.5b: flash routes {K.ROUTES}, expected {L} wgmma")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "qwen2-1.5b: non-finite logits")
    check(tuple(res.seqs.shape) == (8, 32), f"seqs {tuple(res.seqs.shape)}")
    print(f"full size qwen2-1.5b bf16 serve 8x(2048+32): prefill "
          f"{res.prefill_ms:.1f} ms, decode {res.decode_ms_per_token:.3f} "
          f"ms/token, {res.tokens_per_s:.1f} tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}, flash routes "
          f"{K.ROUTES}", flush=True)
    again = serve.serve(model, prompts, T)
    check(torch.equal(again.seqs, res.seqs),
          "qwen2-1.5b: a second serve gave other tokens")
    print(f"second serve: same tokens (prefill {again.prefill_ms:.1f} ms, "
          f"decode {again.decode_ms_per_token:.3f} ms/token)", flush=True)
    cross_check("qwen2-1.5b", model, prompts, res, CROSS_REL)
    torch.cuda.empty_cache()
    profile_serve.profile_serving(model, prompts, 8)
    del model
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"],
            "decode_attention": launches["decode_attention"]}


# ---------------------------------------------------------------------------
# 9. dense training, card vs CPU, on the reduced configs
# ---------------------------------------------------------------------------
#: card against CPU, float32, after TRAIN_STEPS steps from the same state:
#: the losses within 1e-5 relative, grad norms within 1e-4, every
#: parameter within 5% of the steps' summed learning rates (AdamW scales
#: each entry's update by its own gradient's size, so an entry whose
#: gradient is float32 noise moves by its last bits; the CPU tests hold
#: the port to the reference the same way), and without a compressor the
#: moments and ``others`` within 1e-4 of each leaf's largest magnitude
#: (with one, a gradient that differs in its last bits may flip a
#: quantization level or a top-k choice)
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
TRAIN_MOVE, TRAIN_STATE = 0.05, 1e-4
TRAIN_STEPS, TRAIN_PODS, TRAIN_B, TRAIN_S = 3, 2, 4, 64
TRAIN_CASES = [(0, None), (1, None), (2, None), (3, None), (3, "int8"),
               (3, "topk"), (4, None)]


def smoke_batches(cfg, steps, start=0):
    src = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=2))
    return [{k: torch.as_tensor(v).reshape(TRAIN_PODS, -1, TRAIN_S)
             for k, v in src.batch_for_step(i).items()}
            for i in range(start, start + steps)]


def to_device(state, dev):
    if isinstance(state, dict):
        return {k: to_device(v, dev) for k, v in state.items()}
    return state.to(dev)


def state_agrees(label, got, want, lr_sum, compressed):
    """Card state (got) against CPU state (want), at the tolerances
    above; returns the largest parameter difference."""
    want, got = flatten(want), flatten(got)
    worst = 0.0
    for k, w in want.items():
        d = float((got[k].cpu().double() - w.double()).abs().max())
        if k.startswith(("params/", "outer/")):
            check(d <= TRAIN_MOVE * lr_sum,
                  f"{label}: {k} differs by {d} (lr sum {lr_sum})")
            worst = max(worst, d)
        elif not compressed or k in ("step", "opt/step"):
            scale = float(w.double().abs().max())
            check(d <= TRAIN_STATE * max(scale, 1e-30),
                  f"{label}: {k} differs by {d} (largest {scale})")
    return worst


def leaves_per_pod_step(cfg):
    return len(lm.init_params(cfg, device="cpu"))


def train_launches(cfg, pod_steps):
    """The kernel launches of ``pod_steps`` (steps x pods) gradient passes
    of ``cfg``: per attention layer one ``flash_attention``, per Mamba
    layer one ``mamba_scan`` and one ``mamba_scan_backward``, per mLSTM
    layer one ``mlstm_attention`` and one ``mlstm_attention_backward``;
    ``cfg.remat`` runs each forward kernel once more (the recompute).  No
    compressor (the caller adds its kernels)."""
    specs = transformer.block_specs(cfg)
    mixers = [specs[i % len(specs)][0] for i in range(cfg.num_layers)]
    fwd = 2 if cfg.remat else 1
    want = {n: 0 for n in K.LAUNCHES}
    want["flash_attention"] = fwd * mixers.count("attn") * pod_steps
    want["mamba_scan"] = fwd * mixers.count("mamba") * pod_steps
    want["mamba_scan_backward"] = mixers.count("mamba") * pod_steps
    want["mlstm_attention"] = fwd * mixers.count("mlstm") * pod_steps
    want["mlstm_attention_backward"] = mixers.count("mlstm") * pod_steps
    return want


def train_case_card_vs_cpu(cfg, mode, comp, adamw):
    """TRAIN_STEPS steps of ``cfg`` at n_pods = 2 in ``mode`` with
    compressor ``comp`` on the CPU (plain versions) and on the card
    (kernels) from the same state: losses, aux losses, grad norms and the
    states agree; exact launch counts."""
    leaves = leaves_per_pod_step(cfg)
    spec = train.TrainSpec(mode=AsyncMode(mode), compressor=comp,
                           adamw=adamw, outer=OuterConfig(sync_period=2))
    label = f"{cfg.name} mode {mode} {comp or 'plain'}"
    cpu = train.init_train_state(cfg, spec, TRAIN_PODS, seed=0,
                                 device="cpu")
    card = to_device(cpu, "cuda")
    step = train.make_train_step(cfg, spec, TRAIN_PODS)
    lr_sum = 0.0
    real_sum, summed = collectives.cross_pod_sum, []

    def counting_sum(tree, *a, **k):
        # mode 3's sums go through the ported collective
        summed.append(tree.device.type)
        return real_sum(tree, *a, **k)

    collectives.cross_pod_sum = counting_sum
    K.reset_launches()
    try:
        for b in smoke_batches(cfg, TRAIN_STEPS):
            card, got = step(card, to_device(b, "cuda"))
            cpu, want = step(cpu, b)
            lr_sum += float(want["lr"])
            gl, wl = float(got["loss"]), float(want["loss"])
            check(abs(gl / wl - 1) <= TRAIN_LOSS_RTOL,
                  f"{label}: loss {gl} on the card, {wl} on the CPU")
            ga, wa = float(got["aux"]), float(want["aux"])
            check(abs(ga - wa) <= TRAIN_LOSS_RTOL * abs(wa),
                  f"{label}: aux loss {ga} on the card, {wa} on the CPU")
            gn, wn = float(got["grad_norm"]), float(want["grad_norm"])
            check(abs(gn / wn - 1) <= TRAIN_NORM_RTOL,
                  f"{label}: grad norm {gn} vs {wn}")
    finally:
        collectives.cross_pod_sum = real_sum
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    per = TRAIN_STEPS * TRAIN_PODS
    want_l = train_launches(cfg, per)
    if comp == "int8":
        want_l["quantize"] = want_l["dequantize"] = leaves * per
    elif comp == "topk":
        want_l["topk_compress"] = leaves * per
    check(launches == want_l,
          f"{label}: launches {launches}, expected {want_l}")
    worst = state_agrees(label, card, cpu, lr_sum, comp is not None)
    # every mode-3 sum, plain or lossy, goes through the collective
    want_sums = leaves * TRAIN_STEPS if mode == 3 else 0
    check(summed.count("cuda") == want_sums == summed.count("cpu"),
          f"{label}: {summed.count('cuda')} collectives.cross_pod_sum calls "
          f"on the card, expected {want_sums}")
    if mode == 3:
        print(f"{label}: the cross-pod sums through "
              f"collectives.cross_pod_sum, {want_sums} calls on the card "
              f"({leaves} leaves x {TRAIN_STEPS} steps), launches as "
              f"expected", flush=True)
    used = {k: v for k, v in launches.items() if v}
    print(f"{label}: {TRAIN_STEPS} steps card == CPU (loss {wl:.6f}, aux "
          f"{wa:.6g}, largest parameter difference {worst:.3g}); launches "
          f"{used}", flush=True)


@phase("train_card_vs_cpu")
def train_card_vs_cpu():
    """The reduced qwen2-1.5b and qwen3-0.6b, float32, every mode at
    n_pods = 2 and mode 3 with each compressor: TRAIN_STEPS steps on the
    CPU (plain versions) and on the card (kernels) from the same state
    agree; the card's launches are counted.  Then a checkpoint saved on
    the card restores on the CPU bitwise and both continue alike."""
    adamw = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    for arch in ("qwen2-1.5b", "qwen3-0.6b"):
        cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
        for mode, comp in TRAIN_CASES:
            train_case_card_vs_cpu(cfg, mode, comp, adamw)
    # a checkpoint from the card continues on the CPU
    spec = train.TrainSpec(mode=AsyncMode.BEST_EFFORT, compressor="topk",
                           adamw=adamw)
    d = os.path.join(REPO, "build", "chip_smoke_ckpt")
    card = to_device(train.init_train_state(cfg, spec, TRAIN_PODS,
                                            device="cpu"), "cuda")
    step = train.make_train_step(cfg, spec, TRAIN_PODS)
    for b in smoke_batches(cfg, 2):
        card, _ = step(card, to_device(b, "cuda"))
    ckpt.save(d, card, 2)
    cpu = ckpt.restore(d, 2, to_device(card, "cpu"))
    for k, v in flatten(card).items():
        check(torch.equal(flatten(cpu)[k], v.cpu()),
              f"checkpoint: {k} differs after the round trip")
    b = smoke_batches(cfg, 1, start=2)[0]
    card, got = step(card, to_device(b, "cuda"))
    cpu, want = step(cpu, b)
    check(abs(float(got["loss"]) / float(want["loss"]) - 1)
          <= TRAIN_LOSS_RTOL, "checkpoint: the continuations differ")
    state_agrees("checkpoint continuation", card, cpu, float(want["lr"]),
                 True)
    print(f"checkpoint saved on the card at step 2 restores on the CPU "
          f"bitwise; step 3: loss {float(got['loss']):.6f} (card), "
          f"{float(want['loss']):.6f} (CPU)", flush=True)


# ---------------------------------------------------------------------------
# 10. dense training at full width: qwen2-1.5b, mode 3, top-k then int8
# ---------------------------------------------------------------------------
FULL_TRAIN = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "2048",
              "--steps", "6", "--mode", "3", "--n-pods", "1",
              "--log-every", "1", "--device", "cuda", "--seed", "0"]


def real_gradient_kernels(cfg):
    """Step 1's gradient leaves of the full-size run (the same seed's
    weights and first batch; the residuals are still 0, so the
    compressors encode the gradients themselves) through the three
    kernels and their plain versions: bitwise."""
    params = lm.init_params(cfg, seed=0, device="cuda")
    src = SyntheticLM(DataConfig(cfg.vocab_size, 2048, 4, seed=0))
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in src.batch_for_step(0).items()}
    grads, _ = train.pod_grads(params, batch, cfg)
    del params
    payload_kernels("step-1 gradient", grads)
    del grads
    torch.cuda.empty_cache()


def payload_kernels(label, grads):
    """The gradient leaves ``grads`` as the compressors cut them (with a
    zero residual, the payload is the gradient's) through the three
    compression kernels and their plain versions: bitwise."""
    topk = TopKCompressor()
    for name, g in grads.items():
        rows = (g.reshape(g.shape[0], -1) if g.ndim > 2 else
                g if g.ndim == 2 else g.reshape(1, -1))
        k = topk.k_for(rows.shape[-1])
        held(f"{label} {name} {tuple(rows.shape)} topk_compress "
             f"k={k}", topk_compress_blocks(rows, k),
             topk_compress_torch(rows, k))
        qrows = (g.reshape(-1, g.shape[-1]) if g.ndim >= 2 else
                 F.pad(g, (0, -g.numel() % 1024)).reshape(-1, 1024))
        got = quantize_blocks(qrows, residual=True)
        held(f"{label} {name} {tuple(qrows.shape)} quantize", got,
             quantize_torch(qrows, residual=True))
        held(f"{label} {name} dequantize",
             (dequantize_blocks(got[0], got[1]),),
             (dequantize_torch(got[0], got[1]),))
        del got


def leaf_topk_routes(params, steps):
    """Each leaf's top-k route, from its rows as TopKCompressor cuts them
    (every leaf is stacked over pods: shape[1:] is a pod's), counted
    ``steps`` times: {"topk_compress/<route>": launches}."""
    routes = {}
    for leaf in params.values():
        shape = leaf.shape[1:]
        block = math.prod(shape[1:]) if len(shape) >= 2 else \
            math.prod(shape)
        key = f"topk_compress/{topk_route(block)}"
        routes[key] = routes.get(key, 0) + steps
    return routes


@phase("train_full_size")
def train_full_size():
    """qwen2-1.5b at full width through the training entry point: bf16
    compute, float32 masters, batch 4 x seq 2048, n_pods = 1, mode 3, 6
    steps with the top-k compressor and 6 with int8, launch counters
    zeroed just before each run and read just after it.  Returns each new
    kernel's launches on its run."""
    launched = {}
    for comp, used in (("topk", ("topk_compress",)),
                       ("int8", ("quantize", "dequantize"))):
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        state, history = train.main(FULL_TRAIN + ["--compressor", comp])
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        cfg = train.resolve_config("qwen2-1.5b")
        leaves, steps = len(state["params"]), len(history)
        topk_routes = leaf_topk_routes(state["params"], steps)
        del state
        torch.cuda.empty_cache()
        want = {n: 0 for n in launches}
        want["flash_attention"] = 2 * cfg.num_layers * steps
        for n in used:
            want[n] = leaves * steps
        check(launches == want,
              f"full-size {comp}: launches {launches}, expected {want}")
        want_routes = {"flash_attention/wgmma": want["flash_attention"]}
        if comp == "topk":
            want_routes.update(topk_routes)
        check(K.ROUTES == want_routes,
              f"full-size {comp}: routes {K.ROUTES}, expected {want_routes}")
        losses = [h["loss"] for h in history]
        check(all(np.isfinite(losses)), f"full-size {comp}: losses {losses}")
        check(losses[-1] < losses[0],
              f"full-size {comp}: loss did not fall: {losses}")
        ms = [h["ms"] for h in history]
        steady = statistics.mean(ms[1:])
        print(f"full size qwen2-1.5b train mode 3 {comp}: losses "
              f"{[round(x, 4) for x in losses]}, step ms "
              f"{[round(x, 1) for x in ms]}, "
              f"{steady:.1f} ms/step and {4 * 2048 * 1e3 / steady:.0f} "
              f"tokens/s after step 1, peak memory {peak / 2 ** 30:.2f} GiB, "
              f"launches {launches}", flush=True)
        for n in used:
            launched[n] = launches[n]
    real_gradient_kernels(cfg)
    return launched


# ---------------------------------------------------------------------------
# 11. the hybrid LM at full width: one period of jamba-v0.1-52b
# ---------------------------------------------------------------------------
#: layer 0's Mamba state after a prefill of prompt + k tokens against its
#: state after the prompt's prefill and k decode steps, bf16, as a share of
#: the largest magnitude: the two compute the same function (layer 0 reads
#: the embeddings alone, so the MoE's capacity drops do not reach it), but
#: prefill adds the conv taps in bf16 and decode sums them in float32, and
#: cuBLAS rounds the (16384, 4096) and the (8, 4096) in_proj products in
#: other places; h carries those bf16 differences through 2048+ steps
STATE_REL = 5e-2
JAMBA_B, JAMBA_P, JAMBA_T = 8, 2048, 32


def layer0_state(caches):
    return {n: caches[0][n].float().clone() for n in ("h", "conv")}


@phase("jamba_full_size")
def jamba_full_size():
    """One 8-layer period of jamba-v0.1-52b at full width (the only cut is
    depth, 32 -> 8: 51.6 G parameters do not fit the card) in bf16,
    seeded weights, through ``serve.serve``: launch counters zeroed just
    before it and read just after it.  Returns the scan's launches on that
    path."""
    dev = torch.device("cuda")
    cfg = get_config("jamba-v0.1-52b").replace(num_layers=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.cast_params_for_compute(lm.LM(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (JAMBA_B, JAMBA_P),
                            generator=gen, device=dev, dtype=torch.int32)
    print(f"jamba one period (8 layers) at full width: {n_params} "
          f"parameters, built and cast to bf16 in {built:.1f}s (peak "
          f"{build_peak / 2 ** 30:.2f} GiB with the float32 masters), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    torch.cuda.synchronize()
    K.reset_launches()
    res = serve.serve(model, prompts, JAMBA_T)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, JAMBA_T - 1)
    check(launches == want, f"jamba: launches {launches}, expected {want}")
    check(K.ROUTES == {"flash_attention/wgmma": want["flash_attention"],
                       "mamba_scan/tma": want["mamba_scan"]}
          and want["mamba_scan"] == 7,
          f"jamba: routes {K.ROUTES}, expected {want['flash_attention']} "
          f"flash wgmma and 7 mamba_scan tma")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          "jamba: non-finite logits")
    check(tuple(res.seqs.shape) == (JAMBA_B, JAMBA_T),
          f"jamba: seqs {tuple(res.seqs.shape)}")
    print(f"full size jamba (8 layers) bf16 serve {JAMBA_B}x({JAMBA_P}+"
          f"{JAMBA_T}): prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms_per_token:.3f} ms/token, {res.tokens_per_s:.1f} "
          f"tokens/s, serving peak memory {peak / 2 ** 30:.2f} GiB, launches "
          f"{launches}", flush=True)
    again = serve.serve(model, prompts, JAMBA_T)
    check(torch.equal(again.seqs, res.seqs),
          "jamba: a second serve gave other tokens")
    print(f"second serve: same tokens (prefill {again.prefill_ms:.1f} ms, "
          f"decode {again.decode_ms_per_token:.3f} ms/token)", flush=True)
    del again
    # the kernel against its plain version on layer 0's real scan inputs
    block = model.stack.blocks[0]
    with torch.no_grad():
        x = layers.rms_norm(layers.embed(model.embed, prompts,
                                         model.compute_dtype),
                            block.mixer_norm, cfg.norm_eps)
        _, _, xc, dt, Bm, Cm, A = ssm.mamba_scan_inputs(
            layers.leaves(block.mixer), x, cfg)
        args = (xc.float(), dt, Bm.contiguous(), Cm.contiguous(), A)
        held_close("mamba_scan on layer 0's prefill inputs "
                   f"{tuple(xc.shape)}", mamba_scan(*args),
                   mamba_scan_torch(*args), SCAN_TOL)
    del x, xc, dt, Bm, Cm, A, args
    # layer 0's state: prefill of prompt + k tokens against k decode steps
    _, caches = lm.prefill_step(model, prompts, JAMBA_P + JAMBA_T)
    after = {}
    for i in range(JAMBA_T - 1):
        lm.decode_step(model, res.seqs[:, i:i + 1], caches, JAMBA_P + i)
        if i + 1 in (1, JAMBA_T - 1):
            after[i + 1] = layer0_state(caches)
    del caches
    for k, got in after.items():
        _, caches = lm.prefill_step(model, torch.cat([prompts,
                                                      res.seqs[:, :k]], 1))
        want_state = layer0_state(caches)
        del caches
        for name in ("h", "conv"):
            err = float((got[name] - want_state[name]).abs().max())
            scale = float(want_state[name].abs().max())
            check(err <= STATE_REL * scale,
                  f"jamba layer 0 {name}: prefill of prompt + {k} tokens vs "
                  f"{k} decode steps differ by {err} (largest {scale})")
            print(f"jamba layer 0 {name} after prefill of {JAMBA_P + k} "
                  f"tokens vs after {k} decode steps: max |difference| "
                  f"{err:.4g} of largest {scale:.4g}", flush=True)
    torch.cuda.empty_cache()
    profile_serve.profile_serving(model, prompts, 8)
    del model
    torch.cuda.empty_cache()
    return {"mamba_scan": launches["mamba_scan"]}


# ---------------------------------------------------------------------------
# 12. xLSTM at full width: xlstm-125m serving 8 x (2048 + 32)
# ---------------------------------------------------------------------------
#: xlstm-125m's depth cut, 12 -> 6 layers: one period of its block pattern
#: (mLSTM, mLSTM, sLSTM, mLSTM, mLSTM, mLSTM).  The sLSTM's per-position
#: Python loop sets the time of phases 12 and 17, and the script must end
#: within its limit with phase 19 added
XLSTM_LAYERS = 6
#: the cut model's parameters (6 layers, d 768, vocab 50304, tied
#: embeddings; uncut, the reference's ``lm.param_count`` gives 155,640,272)
XLSTM_PARAMS = 97_137_256
#: prefill of prompt + k tokens against decode step k, as a share of the
#: largest logit.  The two are one function (no MoE): in float32 they
#: agree to the order of the float32 sums over 2048+ positions and 12
#: layers (4.2e-5 seen at k = 31).  In bf16 they drift apart with k, unlike
#: qwen2-1.5b's (CROSS_REL): prefill adds the mLSTM conv's taps in bf16 and
#: decode sums them in float32 (the reference's two conventions, mirrored),
#: so from layer 0 on each recurrent state differs by bf16 roundings
#: (about 0.5% of its largest value), and the mLSTM and sLSTM states
#: integrate those differences over the decode steps (1.4% at k = 1 and
#: 6.3% at k = 31 seen; the same growth on the CPU at reduced width)
XLSTM_CROSS_REL = {"float32": 2e-4, "bfloat16": 1e-1}


def serve_xlstm(dtype):
    """xlstm-125m cut to XLSTM_LAYERS, built from seed 0 and cast to
    ``dtype`` as ``serve.main`` builds it, served through ``serve.serve``
    (batch 8, prompt 2048, 32 new tokens), the launch counters zeroed just
    before it and read just after it: exactly one ``mlstm_attention`` per
    mLSTM layer (5) and no other kernel, finite logits, the cut model's
    parameter count.  Returns (model, prompts, result, launches)."""
    dev = torch.device("cuda")
    cfg = get_config("xlstm-125m").replace(num_layers=XLSTM_LAYERS,
                                           dtype=dtype)
    model = lm.cast_params_for_compute(lm.LM(cfg, seed=0, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (FULL_B, FULL_P),
                            generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = serve.serve(model, prompts, FULL_T)
    torch.cuda.synchronize()
    launches, routes = dict(K.LAUNCHES), dict(K.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    B, T = res.seqs.shape
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == XLSTM_PARAMS, f"xlstm-125m: {n_params} parameters")
    want = expected_launches(model.cfg, T - 1)
    check(launches == want and want["mlstm_attention"] == 5,
          f"xlstm-125m {dtype}: launches {launches}, expected {want}")
    route = "wgmma" if dtype == "bfloat16" else "simt"
    check(routes == {f"mlstm_attention/{route}": 5},
          f"xlstm-125m {dtype}: routes {routes}, expected 5 {route}")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          f"xlstm-125m {dtype}: non-finite logits")
    check((B, T) == (8, 32), f"xlstm-125m: seqs {(B, T)}")
    print(f"full size xlstm-125m ({XLSTM_LAYERS} layers, {n_params} "
          f"parameters) {dtype} serve "
          f"8x(2048+32): prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms_per_token:.3f} ms/token, {res.tokens_per_s:.1f} "
          f"tokens/s, peak memory {peak / 2 ** 30:.2f} GiB, launches "
          f"{launches}, routes {routes}", flush=True)
    return model, prompts, res, launches


@phase("xlstm_full_size")
def xlstm_full_size():
    """xlstm-125m at full width, XLSTM_LAYERS deep, through the serving
    path: in bf16 (the config's compute dtype; a second serve, the
    kernel on layer 0's real inputs, prefill against decode, the profile)
    and in float32 (prefill against decode at float32's precision).
    Returns each mLSTM entry point's launches on its run."""
    model, prompts, res, launches = serve_xlstm("bfloat16")
    again = serve.serve(model, prompts, res.seqs.shape[1])
    check(torch.equal(again.seqs, res.seqs),
          "xlstm-125m: a second serve gave other tokens")
    print(f"second serve: same tokens (prefill {again.prefill_ms:.1f} ms, "
          f"decode {again.decode_ms_per_token:.3f} ms/token)", flush=True)
    del again
    # the kernel against its plain version on layer 0's real inputs
    cfg, block = model.cfg, model.stack.blocks[0]
    with torch.no_grad():
        x = layers.rms_norm(layers.embed(model.embed, prompts,
                                         model.compute_dtype),
                            block.mixer_norm, cfg.norm_eps)
        q, k, v, log_i, log_f, _, _ = ssm._mlstm_qkv_gates(
            layers.leaves(block.mixer), x, cfg)
        args = (q, k, v, torch.cumsum(log_f, dim=1), log_i.contiguous())
        held_close(f"mlstm_attention on layer 0's prefill inputs "
                   f"{tuple(q.shape)}", mlstm_attention(*args),
                   mlstm_attention_plain(*args), MLSTM_TOL[torch.bfloat16])
    del x, q, k, v, log_i, log_f, args
    cross_check("xlstm-125m bf16", model, prompts, res,
                XLSTM_CROSS_REL["bfloat16"])
    torch.cuda.empty_cache()
    pre, dec = profile_serve.profile_serving(model, prompts, 8)
    print(f"[serve] xlstm-125m bf16 profiled: prefill "
          f"{pre['wall_ms_per_call']:.1f} ms "
          f"({pre['kernel_launches_per_call']:.0f} launches, device busy "
          f"{pre['device_busy_share']:.3f}), decode "
          f"{dec['wall_ms_per_call']:.3f} ms/step "
          f"({dec['kernel_launches_per_call']:.0f} launches/step, device "
          f"busy {dec['device_busy_share']:.3f})", flush=True)
    del model
    torch.cuda.empty_cache()
    model, prompts, res, launches_f32 = serve_xlstm("float32")
    cross_check("xlstm-125m float32", model, prompts, res,
                XLSTM_CROSS_REL["float32"])
    del model
    torch.cuda.empty_cache()
    return {"mlstm_attention": launches["mlstm_attention"],
            "mlstm_attention_f32": launches_f32["mlstm_attention"]}


# ---------------------------------------------------------------------------
# 13. the MoE LMs: deepseek-moe-16b and dbrx-132b serving at full width,
#     deepseek-moe-16b training at full width
# ---------------------------------------------------------------------------
FULL_B, FULL_P, FULL_T = 8, 2048, 32
#: dbrx-132b's depth cut, 40 -> 8 layers: 8 x 3.26 G parameters and the
#: two 0.62 G tables are 27.3 G parameters, 54.6 GB in bf16, beside about
#: 10 GB of prefill transients (the grouped experts at capacity 640)
DBRX_LAYERS = 8
#: deepseek-moe-16b's training depth cut, 28 -> 3 layers (2.18 G
#: parameters), the deepest that fits: the train state (float32 masters,
#: AdamW m and v, mode 3's ``others``, the top-k residual, the gradient,
#: the bf16 cast) and the step's transients peaked at 48.62 GiB with 2
#: layers and 63.18 GiB with 3 on an H100 80GB HBM3; with 4 the step ran
#: out of the card's 79.18 GiB (each layer adds 0.59 G parameters)
DEEPSEEK_TRAIN_LAYERS = 3


def serve_argv(arch):
    return ["--arch", arch, "--batch", str(FULL_B), "--prompt-len",
            str(FULL_P), "--tokens", str(FULL_T), "--device", "cuda",
            "--seed", "0"]


def full_serve_checked(label, model, prompts, res, launches, routes, peak,
                       frontend=None):
    """The checks of a full-width serve: one ``flash_attention`` a layer
    on the tensor-core route and one ``decode_attention`` a layer and step
    (``expected_launches``), finite logits, (FULL_B, FULL_T) tokens, the
    same tokens from a second serve (with ``frontend``, the prefix the
    first took); prints the ``[serve]`` line."""
    cfg = model.cfg
    want = expected_launches(cfg, FULL_T - 1)
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(routes == {"flash_attention/wgmma": want["flash_attention"]},
          f"{label}: routes {routes}, expected {want['flash_attention']} "
          f"flash wgmma")
    check(all(bool(torch.isfinite(x).all()) for x in res.logits),
          f"{label}: non-finite logits")
    check(tuple(res.seqs.shape) == (FULL_B, FULL_T),
          f"{label}: seqs {tuple(res.seqs.shape)}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {label} ({n_params} parameters, {cfg.dtype}) "
          f"{FULL_B}x({FULL_P}+{FULL_T}): prefill {res.prefill_ms:.1f} ms, "
          f"decode {res.decode_ms_per_token:.3f} ms/step, "
          f"{res.tokens_per_s:.1f} tokens/s, peak {peak / 2 ** 30:.2f} GiB; "
          f"launches {dict((k, v) for k, v in launches.items() if v)}, "
          f"routes {routes}", flush=True)
    again = serve.serve(model, prompts, FULL_T, frontend)
    check(torch.equal(again.seqs, res.seqs),
          f"{label}: a second serve gave other tokens")
    print(f"second serve: same tokens (prefill {again.prefill_ms:.1f} ms, "
          f"decode {again.decode_ms_per_token:.3f} ms/step)", flush=True)


def profiled(label, model, prompts, frontend_embeds=None):
    """``profile_serve.profile_serving`` over one prefill and 8 decode
    steps, summarised in one line."""
    torch.cuda.empty_cache()
    pre, dec = profile_serve.profile_serving(model, prompts, 8,
                                             frontend_embeds)
    print(f"[serve] {label} profiled: prefill {pre['wall_ms_per_call']:.1f} "
          f"ms ({pre['kernel_launches_per_call']:.0f} launches, device busy "
          f"{pre['device_busy_share']:.3f}), decode "
          f"{dec['wall_ms_per_call']:.3f} ms/step "
          f"({dec['kernel_launches_per_call']:.0f} launches/step, device "
          f"busy {dec['device_busy_share']:.3f})", flush=True)


#: every full-width training run: steps, batch, sequence length
TRAIN_RUN_STEPS, TRAIN_RUN_B, TRAIN_RUN_S = 6, 4, 2048
#: xlstm-125m's training steps (fewer than TRAIN_RUN_STEPS for the
#: script's time limit: a step takes ~6 s, host-bound in the sLSTM loops)
XLSTM_TRAIN_STEPS = 2


def train_run(label, cfg, spec, steps=None):
    """``train.run_training`` of ``cfg`` at batch TRAIN_RUN_B x TRAIN_RUN_S
    for TRAIN_RUN_STEPS steps, one pod, on the card, the launch counters
    zeroed just before and read just after: exact launches
    (``train_launches``, plus one ``topk_compress`` a leaf with the top-k
    compressor) and routes (the forward kernels on their tensor-core or
    ``tma`` routes, each leaf's top-k on its own), finite and falling loss,
    finite aux losses.  Prints the ``[train]`` line; returns (launches,
    history, steady ms a step after step 1)."""
    steps = steps or TRAIN_RUN_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    state, history = train.run_training(
        cfg, spec, DataConfig(cfg.vocab_size, TRAIN_RUN_S, TRAIN_RUN_B,
                              seed=0), steps=steps, log_every=1,
        device="cuda", seed=0)
    torch.cuda.synchronize()
    launches, routes = dict(K.LAUNCHES), dict(K.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(v[0].numel() for v in state["params"].values())
    want = train_launches(cfg, steps)
    want_routes = {f"{n}/{r}": want[n] for n, r in (
        ("flash_attention", "wgmma"), ("mamba_scan", "tma"),
        ("mlstm_attention", "wgmma"), ("mlstm_attention_backward", "wgmma"))
        if want[n]}
    if spec.compressor == "topk":
        want["topk_compress"] = len(state["params"]) * steps
        want_routes.update(leaf_topk_routes(state["params"], steps))
    del state
    torch.cuda.empty_cache()
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(routes == want_routes,
          f"{label}: routes {routes}, expected {want_routes}")
    losses = [h["loss"] for h in history]
    auxes = [h["aux"] for h in history]
    check(len(history) == steps and all(np.isfinite(losses + auxes)),
          f"{label}: losses {losses}, aux {auxes}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    ms = [h["ms"] for h in history]
    steady = statistics.mean(ms[1:])
    print(f"[train] {label} ({n_params} parameters), {cfg.dtype} over "
          f"float32 masters, batch {TRAIN_RUN_B} x {TRAIN_RUN_S}, mode "
          f"{int(spec.mode)} {spec.compressor or 'uncompressed'}: losses "
          f"{[round(x, 4) for x in losses]}, aux "
          f"{[round(x, 5) for x in auxes]}, step ms "
          f"{[round(x, 1) for x in ms]}, {steady:.1f} ms/step and "
          f"{TRAIN_RUN_B * TRAIN_RUN_S * 1e3 / steady:.0f} tokens/s after "
          f"step 1, peak {peak / 2 ** 30:.2f} GiB; launches "
          f"{dict((k, v) for k, v in launches.items() if v)}, routes "
          f"{routes}", flush=True)
    return launches, history, steady


def deepseek_train_full_size():
    """deepseek-moe-16b at full width (d 2048, 64 experts of width 1408
    top-6, 2 shared; depth cut to DEEPSEEK_TRAIN_LAYERS) through
    ``train_run``: bf16 compute over float32 masters, mode 3 with the
    top-k compressor: 2 flash launches a layer and step (the forward and
    its recompute), one ``topk_compress`` a leaf and step (each expert
    leaf a row of 184,549,376 a layer); the aux loss positive on every
    step."""
    cfg = get_config("deepseek-moe-16b").replace(
        num_layers=DEEPSEEK_TRAIN_LAYERS)
    spec = train.TrainSpec(mode=AsyncMode.BEST_EFFORT, compressor="topk",
                           adamw=AdamWConfig(lr=3e-3, warmup_steps=20,
                                             total_steps=TRAIN_RUN_STEPS))
    _, history, _ = train_run(
        f"deepseek-moe-16b at full width, {cfg.num_layers} layers", cfg,
        spec)
    auxes = [h["aux"] for h in history]
    check(all(a > 0 for a in auxes), f"deepseek train: aux losses {auxes}")


@phase("moe_full_size")
def moe_full_size():
    """The MoE archs.  Their reduced configs card against CPU: serving
    (``smoke_card_vs_cpu``, float32 and bf16) and training (float32, mode
    3 with top-k and mode 0, ``train_case_card_vs_cpu``).  deepseek-moe-16b
    uncut (28 layers, 16.9 G parameters) through ``serve.main`` and
    dbrx-132b at full width (d 6144, 16 experts of width 10752 top-4, GQA
    48/8), depth cut to DBRX_LAYERS, built leaf by leaf in bf16, through
    ``serve.serve``: batch 8, prompt 2048, 32 new tokens, each with the
    launch counters zeroed just before and read just after, and profiled.
    An MoE's prefill drops pairs over capacity and its decode drops none,
    so prefill and decode are not held to each other.  Then
    ``deepseek_train_full_size``."""
    adamw = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    for arch in ("deepseek-moe-16b", "dbrx-132b"):
        for dtype in ("float32", "bfloat16"):
            smoke_card_vs_cpu(arch, dtype)
        cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
        for mode, comp in ((3, "topk"), (0, None)):
            train_case_card_vs_cpu(cfg, mode, comp, adamw)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    model, prompts, _, res = serve.main(serve_argv("deepseek-moe-16b"))
    torch.cuda.synchronize()
    full_serve_checked("deepseek-moe-16b", model, prompts, res,
                       dict(K.LAUNCHES), dict(K.ROUTES),
                       torch.cuda.max_memory_allocated())
    profiled("deepseek-moe-16b", model, prompts)
    del model, res
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("dbrx-132b").replace(num_layers=DBRX_LAYERS,
                                          param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.LM(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"dbrx-132b at full width, {DBRX_LAYERS} layers: built in bf16 in "
          f"{time.perf_counter() - t0:.1f}s (each leaf drawn in float32 and "
          f"cast at once; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB)", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (FULL_B, FULL_P),
                            generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = serve.serve(model, prompts, FULL_T)
    torch.cuda.synchronize()
    full_serve_checked(f"dbrx-132b ({DBRX_LAYERS} layers)", model, prompts,
                       res, dict(K.LAUNCHES), dict(K.ROUTES),
                       torch.cuda.max_memory_allocated())
    profiled(f"dbrx-132b ({DBRX_LAYERS} layers)", model, prompts)
    del model, res
    torch.cuda.empty_cache()
    deepseek_train_full_size()


# ---------------------------------------------------------------------------
# 14. the audio and vision LMs: musicgen-large and llava-next-mistral-7b
#     serving uncut, with their frontend prefix
# ---------------------------------------------------------------------------
def pipeline_step_card_vs_cpu(arch):
    """One training step of ``arch``'s reduced config, float32, on each
    device from the same state, its batch from a ``Pipeline`` on that
    device (the frontend input included): the same loss and state."""
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    spec = train.TrainSpec(adamw=AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=20))
    data = DataConfig(cfg.vocab_size, 64, 4, seed=3)
    cpu = train.init_train_state(cfg, spec, 1, seed=0, device="cpu")
    card = to_device(cpu, "cuda")
    step = train.make_train_step(cfg, spec, 1)
    out = {}
    for dev, state in (("cuda", card), ("cpu", cpu)):
        pipe = Pipeline(data, cfg, device=dev)
        k, batch = next(pipe)
        pipe.close()
        check(k == 0 and sorted(batch) == sorted(
            ["tokens", "labels", frontend_input_name(cfg)])
            and all(v.device.type == dev for v in batch.values()),
            f"{arch}: pipeline batch {k} {sorted(batch)} on {dev}")
        K.reset_launches()
        out[dev] = step(state, {n: v[None] for n, v in batch.items()})[1]
        torch.cuda.synchronize()
        check(K.LAUNCHES["flash_attention"] == (2 * cfg.num_layers if
                                                 dev == "cuda" else 0),
              f"{arch}: launches {K.LAUNCHES} on {dev}")
    gl, wl = float(out["cuda"]["loss"]), float(out["cpu"]["loss"])
    check(abs(gl / wl - 1) <= TRAIN_LOSS_RTOL,
          f"{arch}: pipeline step loss {gl} on the card, {wl} on the CPU")
    worst = state_agrees(f"{arch} pipeline step", card, cpu,
                         float(out["cpu"]["lr"]), False)
    print(f"{cfg.name}: one step from the Pipeline's batches, card == CPU "
          f"(loss {wl:.6f}, largest parameter difference {worst:.3g})",
          flush=True)


@phase("modality_full_size")
def modality_full_size():
    """The audio and vision archs.  Their reduced configs card against CPU
    with the frontend prefix spliced (``smoke_card_vs_cpu``, float32 and
    bf16) and one training step each through the ``Pipeline``.  Then
    musicgen-large uncut (48 layers, 3.2 G parameters, MHA at hd 64) and
    llava-next-mistral-7b uncut (32 layers, 7.2 G parameters, GQA 32/8 at
    hd 128) through ``serve.main``: batch 8, prompt 2048 whose first 256
    (musicgen) or 576 (llava) positions are the frontend prefix, 32 new
    tokens, in bf16, the launch counters zeroed just before and read just
    after; prefill of the prompt plus k tokens gives decode step k's
    logits within CROSS_REL (phase 8's); profiled."""
    for arch in ("musicgen-large", "llava-next-mistral-7b"):
        for dtype in ("float32", "bfloat16"):
            smoke_card_vs_cpu(arch, dtype)
        pipeline_step_card_vs_cpu(arch)
    for arch in ("musicgen-large", "llava-next-mistral-7b"):
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        model, prompts, frontend, res = serve.main(serve_argv(arch))
        torch.cuda.synchronize()
        cfg = model.cfg
        check(frontend is not None and tuple(frontend.shape) == (
            FULL_B, cfg.frontend_len, cfg.d_model),
              f"{arch}: frontend prefix {frontend}")
        full_serve_checked(arch, model, prompts, res, dict(K.LAUNCHES),
                           dict(K.ROUTES), torch.cuda.max_memory_allocated(),
                           frontend)
        cross_check(arch, model, prompts, res, CROSS_REL, frontend)
        profiled(arch, model, prompts, frontend)
        del model, res, frontend
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 15. the jamba and xLSTM blocks trained: card vs CPU on the reduced
#     configs, then jamba (one period, no experts) and xlstm-125m (uncut)
#     at full width
# ---------------------------------------------------------------------------
#: jamba-v0.1-52b cut for training on one card: one period (8 layers, the
#: least ``block_specs`` allows) and no experts (16 -> 0): 2.73 G
#: parameters, whose float32 masters, AdamW moments, mode 3's delayed sum
#: and gradients take about 55 GB; with the 16 experts one period is 13.3 G
#: (266 GB of such state).  The MoE FFN trains at full width in phase 13
JAMBA_TRAIN_CUT = dict(num_layers=8, num_experts=0, experts_per_tok=0,
                       moe_d_ff=0)
#: its peak learning rate (warmup 20 steps).  At 3e-3, as phase 13 trains
#: deepseek, the loss spikes at step 3 (8.38 -> 30.18), and the rate at this
#: width is the cause, not the Mamba blocks, their kernels or bf16
#: (``python -m repro_torch.launch.train_ablation`` on an H100 80GB HBM3 at
#: 700 W): in float32 compute the loss spikes alike (8.38 -> 29.79), with
#: attention in place of every Mamba mixer it spikes at step 2 (11.89 ->
#: 18.39), and the scan's backward kernel stays within 2.1e-6 of its plain
#: version on every step's own inputs, step 3's included
JAMBA_TRAIN_LR = 1e-3
#: positions of the profiled sLSTM layer: its Python loop launches the same
#: kernels at every position, so a profile at 256 gives the launches a
#: position; one at 2048 takes minutes of the profiler's own time
SLSTM_PROFILE_S = 256


def grads_card_vs_cpu(cfg):
    """One pod's loss and gradients (``train.pod_grads``, remat on) of
    ``cfg`` on the CPU (plain versions) and on the card (kernels, forward
    and backward) from the same weights and batch: ce and aux within
    TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_STATE of its largest
    magnitude (the CPU tests' tolerance against jax.grad), exact
    launches."""
    params = lm.init_params(cfg, seed=6, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(DataConfig(
        cfg.vocab_size, 64, 4, seed=6)).batch_for_step(0).items()}
    want, wm = train.pod_grads(params, batch, cfg)
    K.reset_launches()
    got, gm = train.pod_grads(to_device(params, "cuda"),
                              to_device(batch, "cuda"), cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches == train_launches(cfg, 1),
          f"{cfg.name} gradients: launches {launches}, expected "
          f"{train_launches(cfg, 1)}")
    for name in ("ce", "aux"):
        g, w = float(gm[name]), float(wm[name])
        check(abs(g - w) <= TRAIN_LOSS_RTOL * abs(w),
              f"{cfg.name} gradients: {name} {g} on the card, {w} on the "
              f"CPU")
    worst = 0.0
    for k, w in want.items():
        d = float((got[k].cpu().double() - w.double()).abs().max())
        scale = float(w.double().abs().max())
        check(d <= TRAIN_STATE * scale,
              f"{cfg.name} gradients: {k} differs by {d} (largest {scale})")
        worst = max(worst, d / max(scale, 1e-30))
    print(f"{cfg.name} float32 gradients card == CPU (ce "
          f"{float(wm['ce']):.6f}, aux {float(wm['aux']):.6g}; worst leaf "
          f"{worst:.3g} of its largest magnitude); launches "
          f"{dict((k, v) for k, v in launches.items() if v)}", flush=True)
    return launches


@phase("ssm_train_card_vs_cpu")
def ssm_train_card_vs_cpu():
    """The reduced jamba-v0.1-52b (7 Mamba blocks, one attention, MoE on
    every other layer) and xlstm-125m (mLSTM, sLSTM and ffn43 blocks) in
    float32 through ``grads_card_vs_cpu``.  Their gradients are held after
    one pass from the same weights, not by phase 9's multi-step check:
    after TRAIN_STEPS steps the two devices' weights differ by AdamW's
    noise-level moves, and on the reduced jamba that check fails with no
    fault in a kernel (uncompressed, a rarely routed expert's moments
    drift past TRAIN_STATE; with top-k, one flipped choice moves a weight
    by a step's learning rate).  Returns the float32 (``simt``) launches of
    ``mlstm_attention_backward``."""
    for arch in ("jamba-v0.1-52b", "xlstm-125m"):
        launches = grads_card_vs_cpu(reduce_for_smoke(
            get_config(arch)).replace(dtype="float32"))
    return {"mlstm_attention_backward_f32":
            launches["mlstm_attention_backward"]}


@phase("jamba_train_full_size")
def jamba_train_full_size():
    """jamba-v0.1-52b at full width (d 4096, di 8192, N 16, GQA 32/8, d_ff
    14336, vocab 65536) cut to JAMBA_TRAIN_CUT, through ``train_run``:
    bf16 compute over float32 masters, remat, mode 3 without a
    compressor: 7 ``mamba_scan_backward`` launches a step, 14
    ``mamba_scan`` (forward and recompute, on ``tma``), 2
    ``flash_attention``; the loss falls.  Then one step profiled
    (``profile_train.profile_step``: launches, busy share, the kernels
    that take the most device time).  Returns the backward kernel's
    launches on the training run."""
    cfg = get_config("jamba-v0.1-52b").replace(**JAMBA_TRAIN_CUT)
    spec = train.TrainSpec(mode=AsyncMode.BEST_EFFORT,
                           adamw=AdamWConfig(lr=JAMBA_TRAIN_LR,
                                             warmup_steps=20,
                                             total_steps=TRAIN_RUN_STEPS))
    label = "jamba-v0.1-52b at full width, one period, no experts"
    launches, _, _ = train_run(label, cfg, spec)
    rec = profile_train.profile_step(cfg, spec, TRAIN_RUN_B, TRAIN_RUN_S,
                                     device=torch.device("cuda"))
    torch.cuda.empty_cache()
    print(f"[train] {label}, one step profiled: {json.dumps(rec)}",
          flush=True)
    return {"mamba_scan_backward": launches["mamba_scan_backward"]}


@phase("xlstm_train_full_size")
def xlstm_train_full_size():
    """xlstm-125m at full width (d 768, hd 384), XLSTM_LAYERS deep,
    through ``train_run``:
    bf16 over float32 masters, remat, mode 3 with the top-k compressor
    (phase 10's): 5 ``mlstm_attention_backward`` launches a step, 10
    ``mlstm_attention`` (forward and recompute, on ``wgmma``), one
    ``topk_compress`` a leaf; the loss falls.  Then one sLSTM layer's
    work in a step, profiled (``profile_train.profile_slstm``) at
    SLSTM_PROFILE_S positions: the Python loop's launches a position and
    busy share, and from them the launches of a step's sLSTM loops,
    extrapolated.  Returns the backward kernel's launches on the training
    run."""
    cfg = get_config("xlstm-125m").replace(num_layers=XLSTM_LAYERS)
    spec = train.TrainSpec(mode=AsyncMode.BEST_EFFORT, compressor="topk",
                           adamw=AdamWConfig(lr=3e-3, warmup_steps=20,
                                             total_steps=TRAIN_RUN_STEPS))
    launches, _, steady = train_run(f"xlstm-125m {XLSTM_LAYERS} layers",
                                    cfg, spec, steps=XLSTM_TRAIN_STEPS)
    rec = profile_train.profile_slstm(cfg, TRAIN_RUN_B, SLSTM_PROFILE_S,
                                      torch.device("cuda"))
    n = rec["slstm_layers_per_step"]
    per = rec["kernel_launches_per_call"] / SLSTM_PROFILE_S
    print(f"[train] xlstm-125m: one sLSTM layer's forward, recompute and "
          f"backward at batch {TRAIN_RUN_B} x {SLSTM_PROFILE_S}: "
          f"{rec['wall_ms_per_call']:.1f} ms (profiler on), "
          f"{rec['kernel_launches_per_call']:.0f} launches ({per:.1f} a "
          f"position), device busy {rec['device_busy_share']:.3f}; "
          f"extrapolated to {TRAIN_RUN_S} positions and {n} such layers: "
          f"{per * TRAIN_RUN_S * n:.0f} launches in the step of "
          f"{steady:.1f} ms", flush=True)
    return {"mlstm_attention_backward":
            launches["mlstm_attention_backward"]}


# ---------------------------------------------------------------------------
# 18. the sharded engine: S shards on the card
# ---------------------------------------------------------------------------
class HopCounter:
    """While installed, counts the sharded engine's hops (every one goes
    through ``mesh.hop``) and the bytes they move."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def __enter__(self):
        real = self._real = mesh.hop

        def counting(x, off, dim=0, group=None):
            self.calls += 1
            self.bytes += x.numel() * x.element_size()
            return real(x, off, dim, group)

        mesh.hop = counting
        return self

    def __exit__(self, *exc):
        mesh.hop = self._real


#: phase 18's horizon after its unsharded comparison (cut from 0.02 for
#: the script's time limit): the other schedulers, 64 shards and the
#: faulty node
SHARDED_DEPTH = 0.005


def drive_sharded(label, kw, duration=0.02):
    """Phase 6's graph-coloring torus-4096 (duration 0.02, probed every 256
    windows) through ``drive`` with the sharded engine's RunConfig fields
    ``kw``: the edge-major drain and send launch once a window phase over
    all shards, nothing else launches, and the hops move each superstep's
    boundary traffic.  Prints updates/s, ms a window (``drive``), the
    windows executed against the windows the horizon needs, duct launches
    a window, hops a superstep and bytes a hop."""
    with HopCounter() as hops:
        res, windows, launches, routes = drive(label, "graphcolor", 4096, 1,
                                               duration, kw)
    w = kw.get("superstep_windows", 1)
    supersteps = windows // w
    used = launches["duct_exchange"]
    check(used > 0 and set(routes) == {"duct_exchange/drain",
                                       "duct_exchange/send"},
          f"{label}: routes {routes}")
    check(sum(launches.values()) == used,
          f"{label}: other kernels launched: {launches}")
    # a superstep: W drains, W - 1 interior sends, W push passes; the
    # pipelined scheduler's epilogue flush pushes W more
    flush = w if kw.get("scheduler") == "pipelined" else 0
    check(routes["duct_exchange/drain"] == windows and
          routes["duct_exchange/send"] == supersteps * (2 * w - 1) + flush,
          f"{label}: routes {routes} in {windows} windows")
    # two hops an offset a superstep (payload, accept bits); the flush
    # returns one more an offset
    per_offset = 2 * supersteps + (1 if flush else 0)
    check(hops.calls > 0 and hops.calls % per_offset == 0,
          f"{label}: {hops.calls} hops in {supersteps} supersteps")
    # best-effort: every process steps each window until it is done, so
    # the horizon needs as many windows as the busiest process's updates
    needed = max(res.updates)
    check(needed <= windows, f"{label}: {windows} windows, {needed} needed")
    print(f"full size {label}: {windows} windows executed, {needed} needed "
          f"by the horizon, {used / windows:.3f} duct launches a window, "
          f"{2 * hops.calls // per_offset} hops a superstep, "
          f"{hops.bytes / hops.calls:.0f} bytes a hop", flush=True)
    return res, routes


@phase("sharded")
def sharded(window_sig):
    """The sharded engine on the card.  (a) phase 4's dyadic scenarios at
    8 shards give the event oracle's signature (the sharded engine keeps
    one row order, edge-major, whatever ``layout`` asks for); (b) 8
    shards on the card equal 8 on the CPU; (c) the torus-4096 at full
    width: 8 shards with the window scheduler equal phase 6's unsharded
    result (``window_sig``), then at 0.005 s the window again, W=8 under
    ``superstep`` and ``pipelined``, and 64 shards; (d) the paper's
    faulty node at 8 shards, W=8.  Returns the edge-major entry points'
    launches on (c)'s 8-shard window run."""
    oracle_on_card(layouts=("edge",), shards=8)
    card_equals_cpu([
        ("graphcolor", "torus", 1024, 64, {"shards": 8}),
        ("graphcolor", "torus", 1024, 64, {"shards": 8,
                                            "superstep_windows": 8}),
        ("graphcolor", "torus", 1024, 64, {"shards": 8,
                                            "superstep_windows": 8,
                                            "scheduler": "pipelined"}),
        ("evo", "torus", 64, 64, {"shards": 8})])
    res, routes = drive_sharded("graphcolor torus-4096 8 shards window",
                                {"shards": 8})
    check(qos_signature(res) == window_sig,
          "torus-4096: 8 shards differ from phase 6's unsharded run")
    print("graphcolor torus-4096: 8 shards == unsharded per-window (full "
          "SimResult incl. quality)", flush=True)
    # the other schedulers and shard counts at one shorter horizon
    # (SHARDED_DEPTH, cut for the script's time limit) and one chunk, so
    # every run executes as many windows: timed and counted, not compared
    for label, kw in (
            ("8 shards window short", {"shards": 8}),
            ("8 shards superstep8", {"shards": 8, "superstep_windows": 8}),
            ("8 shards pipelined8", {"shards": 8, "superstep_windows": 8,
                                     "scheduler": "pipelined"}),
            ("64 shards window", {"shards": 64})):
        drive_sharded(f"graphcolor torus-4096 {label}", kw,
                      duration=SHARDED_DEPTH)
    faulty_node()
    return {"duct_exchange_drain": routes["duct_exchange/drain"],
            "duct_exchange_send": routes["duct_exchange/send"]}


def faulty_node():
    """The paper's faulty node through the CLI's faults family: cliques-256
    at 8 shards, W=8, duration SHARDED_DEPTH, one host degraded (compute
    and links 30x): the faulty clique's and the global median QoS, without
    and with it."""
    argv = ["--family", "faults", "--engine", "torch", "--device", "cuda",
            "--topology", "cliques", "--procs", "256", "--shards", "8",
            "--superstep-windows", "8", "--duration", str(SHARDED_DEPTH)]
    K.reset_launches()
    t0 = time.perf_counter()
    rows = experiments.main(argv)
    wall = time.perf_counter() - t0
    check(K.LAUNCHES["duct_exchange"] > 0, "faults: no duct launches")
    med = {}
    for row in rows:
        med[row["label"]] = {g: {m: row["qos"][g][m]["median"]
                                 for m in row["qos"][g]}
                             for g in ("clique", "global")}
        for g in ("clique", "global"):
            vals = med[row["label"]][g].values()
            check(all(v is not None and math.isfinite(v) for v in vals),
                  f"faults {row['label']} {g}: medians {vals}")
        print(f"faulty node {row['label']}: medians "
              f"{json.dumps(med[row['label']])}", flush=True)
    period = {label: med[label]["clique"]["simstep_period"] for label in med}
    check(period["with_fault"] > period["without_fault"],
          f"faults: the faulty clique's step period did not grow {period}")
    print(f"faulty node cliques-256, 8 shards, W=8: clique median step "
          f"period {period['without_fault'] * 1e6:.3f} -> "
          f"{period['with_fault'] * 1e6:.3f} us, global "
          f"{med['without_fault']['global']['simstep_period'] * 1e6:.3f} -> "
          f"{med['with_fault']['global']['simstep_period'] * 1e6:.3f} us "
          f"({wall:.1f}s wall, {K.LAUNCHES['duct_exchange']} duct launches)",
          flush=True)


# ---------------------------------------------------------------------------
# 19. the live-service path: open-loop arrivals, churn epochs, SLO verdicts
# ---------------------------------------------------------------------------
#: the serve fields of the dyadic serve configs (tests/test_service.py):
#: bin edges and the item cost are powers of two, so the engines agree
SERVE_DYADIC = dict(arrival_rate=2e5, arrival_bin=2 ** -11,
                    arrival_period=2 ** -9, per_item_cost=2 ** -19,
                    service_chunk=4)
#: (arrival shape, mode): poisson keeps clocks lockstep under saturation,
#: rolling barriers pin bursty too
SERVE_CASES = (("poisson", AsyncMode.BEST_EFFORT),
               ("diurnal", AsyncMode.BEST_EFFORT),
               ("bursty", AsyncMode.ROLLING_BARRIER))


class ServeMeter:
    """While installed, times a serve run's windows (the torch engines'
    ``run_batch``, less the arrival tables built inside it) and its
    arrival tables (``cum_arrivals``), and sums the updates, the windows
    executed (a batch's windows once for each of its replicates) and the
    windows the epochs needed (each replicate's busiest process's
    updates)."""

    def __enter__(self):
        self.windows_s = self.tables_s = 0.0
        self.updates = self.windows = self.needed = 0
        self._saved = [(engine_torch, "cum_arrivals"),
                       (engine_torch.TorchEngine, "run_batch"),
                       (ShardedTorchEngine, "run_batch"),
                       (engine_torch.TorchEngine, "run_replicates")]
        self._saved = [(o, a, o.__dict__[a]) for o, a in self._saved]
        real_table = engine_torch.cum_arrivals

        def cum_arrivals(*a):
            t0 = time.perf_counter()
            out = real_table(*a)
            self.tables_s += time.perf_counter() - t0
            return out

        def timed(real):
            def run_batch(eng, seeds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry, windows = real(eng, seeds)
                torch.cuda.synchronize()
                self.windows_s += time.perf_counter() - t0
                self.windows += windows * len(seeds)
                return carry, windows
            return run_batch

        real_reps = engine_torch.TorchEngine.run_replicates

        def run_replicates(eng, seeds):
            out = real_reps(eng, seeds)
            for res in out:
                self.updates += sum(res.updates)
                self.needed += max(res.updates)
            return out

        engine_torch.cum_arrivals = cum_arrivals
        engine_torch.TorchEngine.run_batch = timed(
            engine_torch.TorchEngine.run_batch)
        ShardedTorchEngine.run_batch = timed(ShardedTorchEngine.run_batch)
        engine_torch.TorchEngine.run_replicates = run_replicates
        return self

    def __exit__(self, *exc):
        for obj, attr, real in self._saved:
            setattr(obj, attr, real)


def serve_oracle_on_card():
    """(a) The dyadic serve scenarios on torus-16 (duration 2**-8): the
    torch engine on the card, dense and edge, gives the event oracle's
    ``service`` and ``qos_signature`` (quality excluded)."""
    seed = case_seed("torus")
    for shape, mode in SERVE_CASES:
        cfg = dyadic_cfg(mode=mode, seed=seed, arrival_shape=shape,
                         **{**SERVE_DYADIC, "duration": 2 ** -8})
        ev = make_engine("event", gc_app(16, "torus", seed), cfg).run()
        want = qos_signature(ev)
        want.pop("quality")
        for kw in ({"layout": "dense"}, {"layout": "edge"}):
            res = make_engine(RunConfig(engine="torch", **kw),
                              gc_app(16, "torus", seed), cfg,
                              max_pops=EXACT_MAX_POPS, chunk=64,
                              device="cuda").run()
            got = qos_signature(res)
            got.pop("quality")
            check(res.service == ev.service and got == want,
                  f"serve {shape} {json.dumps(kw)}: torch on the card != "
                  "event oracle")
            check(sum(res.service["served"]) > 0, f"serve {shape}: idle")
        print(f"serve {shape} (mode {int(mode)}): dense and edge on the "
              f"card == event oracle (service: "
              f"{sum(ev.service['arrivals'])} arrivals, "
              f"{sum(ev.service['served'])} served)", flush=True)


def count_service_launches(launched, app_name):
    """Add this run's duct launches to ``launched``, keyed by kernel
    entry (evo's halos are float32: its launches are the f32 entries)."""
    f32 = "_f32" if app_name == "evo" else ""
    for name in ("duct_window", "duct_commit"):
        key = name + f32
        launched[key] = launched.get(key, 0) + K.LAUNCHES[name]
    for route in ("drain", "send", "full"):
        key = "duct_exchange" + ("" if route == "full" else f"_{route}")
        launched[key] = (launched.get(key, 0) +
                         K.ROUTES.get(f"duct_exchange/{route}", 0))


def serve_card_equals_cpu(launched):
    """(b) ``run_service`` end to end (churn 2: a host fault and heal, a
    process leave and rejoin; two replicates; app state carried;
    duration 2**-9) on the card and on the CPU: the whole output dict
    equal, on graph coloring's torus-1024 and evo's torus-64, dense per
    window, W=4 and edge; and dense == W=4 == edge on the card."""
    seed = case_seed("torus")
    for app_name, n, simels in (("graphcolor", 1024, 1), ("evo", 64, 16)):
        topo = make_topology("torus", n)
        # five epochs of about 30 updates: bins of 2**-13 s, so each epoch
        # spans several; chunks of 32 windows, so few run past an epoch
        cfg = dyadic_cfg(seed=seed, **{**SERVE_DYADIC, "duration": 2 ** -9,
                                       "arrival_bin": 2 ** -13})
        timeline = default_timeline(topo, 2, cfg.duration)

        def builder(topology, s, init_state=None):
            return experiments.make_app(app_name, topology.n, simels,
                                        topology, s,
                                        initial_state=init_state)

        on_card = []
        for kw in ({}, {"superstep_windows": 4}, {"layout": "edge"}):
            label = f"serve {app_name} torus-{n} {json.dumps(kw)}"
            outs = {}
            for device in ("cuda", "cpu"):
                K.reset_launches()
                t0 = time.perf_counter()
                outs[device] = run_service(
                    RunConfig(engine="torch", replicates=2, **kw), builder,
                    cfg, topo, timeline, chunk=32, device=device)
                dt = time.perf_counter() - t0
                used = sum(K.LAUNCHES.values())
                check((used > 0) == (device == "cuda"),
                      f"{label} on {device}: {used} kernel launches")
                if device == "cuda":
                    count_service_launches(launched, app_name)
                svc = outs[device]["service"]
                print(f"{label} {device}: {len(outs[device]['epochs'])} "
                      f"epochs, {svc['arrivals']} arrivals, "
                      f"{svc['served']} served, {dt:.1f}s wall, {used} "
                      f"kernel launches", flush=True)
            check(len(outs["cuda"]["epochs"]) == 5 and
                  outs["cuda"]["service"]["served"] > 0,
                  f"{label}: epochs {outs['cuda']['epochs']}")
            check(outs["cuda"] == outs["cpu"],
                  f"{label}: card and CPU run_service outputs differ")
            print(f"{label}: card == CPU (the whole run_service dict)",
                  flush=True)
            on_card.append(outs["cuda"])
        check(on_card[0] == on_card[1] == on_card[2],
              f"serve {app_name} torus-{n}: dense, W=4 and edge differ")
        print(f"serve {app_name} torus-{n}: dense == W=4 == edge on the card "
              "(the whole run_service dict)", flush=True)


def serve_full_size(label, argv, launched):
    """(c) One serve run at full width through the CLI
    (``experiments.main``), launch counters zeroed just before it; prints
    its epochs, service totals, SLO summary, wall s, updates/s, windows
    executed and needed, duct launches a window, and the time in the
    windows, in the arrival tables and outside the windows (epoch
    rebuilds, result assembly, SLO scoring).  Returns its output row."""
    argv = ["--family", "serve", "--engine", "torch", "--device", "cuda",
            "--topology", "torus", "--procs", "4096", "--simels", "1",
            "--buffer", "64", "--duration", "0.02", "--arrival-rate", "1e5",
            *argv]
    torch.cuda.synchronize()
    K.reset_launches()
    with ServeMeter() as m:
        t0 = time.perf_counter()
        rows = experiments.main(argv)
        wall = time.perf_counter() - t0
    count_service_launches(launched, "graphcolor")
    duct = sum(K.LAUNCHES.values())
    check(duct > 0, f"{label}: no duct launches")
    row = rows[0]
    svc, slo = row["service"], row["slo"]["summary"]
    check(svc["served"] > 0 and
          svc["arrivals"] == svc["served"] + svc["backlog"],
          f"{label}: service {svc}")
    med = {k: row["qos"][k]["median"] for k in row["qos"]}
    check(all(v is not None and math.isfinite(v) for v in med.values()),
          f"{label}: medians {med}")
    check(m.needed <= m.windows, f"{label}: {m.windows} windows executed, "
          f"{m.needed} needed")
    in_windows = m.windows_s - m.tables_s
    print(f"serve full size {label}: {len(row['epochs'])} epochs "
          f"{[(e['n_procs'], e['absent_pids'], e['faulty_hosts']) for e in row['epochs']]}, "
          f"{svc['arrivals']} arrivals, {svc['served']} served, "
          f"{svc['backlog']} backlog; slo {slo['intervals']} intervals, "
          f"{slo['breaches']} breaches, max burn {slo['max_burn_rate']:.2f}, "
          f"{'OK' if slo['ok'] else 'BREACH'}; {wall:.2f}s wall, "
          f"{m.updates} updates, {m.updates / wall:.0f} updates/s; "
          f"{m.windows} windows executed, {m.needed} needed; "
          f"{duct / m.windows:.3f} duct launches a window "
          f"({ {k: v for k, v in {**K.LAUNCHES, **K.ROUTES}.items() if v} }); "
          f"in the windows "
          f"{in_windows:.2f}s ({in_windows * 1e3 / m.windows:.3f} ms a "
          f"window), arrival tables {m.tables_s:.3f}s, outside the windows "
          f"{wall - m.windows_s:.2f}s", flush=True)
    print(f"serve full size {label} QoS medians: {json.dumps(med)}",
          flush=True)
    return {k: row[k] for k in ("epochs", "qos", "qos_timeseries", "slo",
                                "service")}


def serve_hook_cost():
    """What the serve hook adds to a window: ``profile_window`` on the
    torus-4096 dense window at 32 windows, without and with arrivals (1e5
    a process a virtual second): CUDA launches and device busy ms a
    window (``--layout edge`` and ``--shards 8`` add as many)."""
    for label, argv in (("dense", []),):
        prof = {}
        for rate in ("0", "1e5"):
            prof[rate] = profile_window.main(
                ["--windows", "32", "--arrival-rate", rate, *argv])
        off, on = prof["0"], prof["1e5"]
        check(on["kernel_launches_per_window"] >
              off["kernel_launches_per_window"],
              f"serve hook {label}: no launches added")
        print(f"serve hook {label}: CUDA launches a window "
              f"{off['kernel_launches_per_window']:.1f} -> "
              f"{on['kernel_launches_per_window']:.1f}, device busy ms a "
              f"window {off['device_busy_ms_per_window']:.4f} -> "
              f"{on['device_busy_ms_per_window']:.4f}, wall ms a window "
              f"(profiler on) {off['wall_ms_per_window']:.3f} -> "
              f"{on['wall_ms_per_window']:.3f}", flush=True)


@phase("service")
def service():
    """The live-service path on the card: (a) the dyadic serve scenarios
    against the event oracle; (b) ``run_service`` card = CPU, and dense =
    W=4 = edge; (c) the torus-4096 at full width through ``--family
    serve``: bursty traffic with churn 2 (five epochs: a host fault and
    heal, a process leave and rejoin), dense = edge, and poisson with
    churn 1 at 8 shards = unsharded; then the serve hook's launches and
    device time a window.
    Returns each duct entry's launches over (b) and (c)."""
    launched = {}
    serve_oracle_on_card()
    serve_card_equals_cpu(launched)
    # both runs at 0.01 virtual s (cut from 0.02 for the script's time
    # limit)
    base = ["--traffic", "bursty", "--churn", "2", "--duration", "0.01"]
    dense = serve_full_size("bursty churn 2 dense", base, launched)
    edge = serve_full_size("bursty churn 2 edge", base + ["--layout", "edge"],
                           launched)
    check([e["n_procs"] for e in dense["epochs"]] ==
          [4096, 4096, 4096, 4095, 4096] and
          dense["epochs"][1]["faulty_hosts"] and
          dense["epochs"][3]["absent_pids"],
          f"bursty churn 2: epochs {dense['epochs']}")
    check(dense == edge, "bursty churn 2: dense and edge outputs differ")
    print("serve torus-4096 bursty churn 2: dense == edge (the whole "
          "run_service dict)", flush=True)
    base = ["--traffic", "poisson", "--churn", "1", "--duration", "0.01"]
    one = serve_full_size("poisson churn 1 unsharded", base, launched)
    eight = serve_full_size("poisson churn 1 8 shards",
                            base + ["--shards", "8"], launched)
    check(eight == one, "poisson churn 1: 8 shards differ from unsharded")
    print("serve torus-4096 poisson churn 1: 8 shards == unsharded (the "
          "whole run_service dict)", flush=True)
    serve_hook_cost()
    return launched


# ---------------------------------------------------------------------------
# 20. spmd: the conduits, the collectives and graph coloring's spmd_step
# ---------------------------------------------------------------------------
#: the reference's single-pod production mesh, a 256 x 256 block a device
SPMD_MESH, SPMD_BLOCK, SPMD_COLORS, SPMD_B = (16, 16), (256, 256), 3, 0.1
SPMD_STEPS, SPMD_CHECK_STEPS, SPMD_PROFILE_STEPS = 400, 8, 8
#: the modes of the full-size runs: (label, mode, flush period)
SPMD_RUNS = (("mode 0", AsyncMode.BARRIER_EVERY_STEP, None),
             ("mode 3", AsyncMode.BEST_EFFORT, None),
             ("mode 4", AsyncMode.NO_COMM, None),
             ("mode 1 flush/8", AsyncMode.ROLLING_BARRIER, 8))
#: one of qwen2-1.5b's (8960, 1536) gradient leaves at 2 pods
SPMD_LEAF = (2, 8960, 1536)


def ring_exchanges(mode, dev):
    """``test_conduit_staleness_semantics`` on an 8-long ring: two
    exchanges of the ranks (then + 100); modes 1/2 flush on the second."""
    cond = conduit.Conduit("x", {"fwd": 1}, mode)
    val = torch.arange(8, dtype=torch.float32, device=dev)
    bufs = cond.init_buffers(val)
    flush = [torch.tensor(f, device=dev) for f in (False, True)]
    kw = mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER)
    r1, bufs = cond.exchange(val, bufs, **({"flush": flush[0]} if kw else {}))
    r2, bufs = cond.exchange(val + 100, bufs,
                             **({"flush": flush[1]} if kw else {}))
    return r1["fwd"], r2["fwd"], bufs["fwd"]


def conduits_on_card():
    """(a) the reference's staleness semantics on the card, and the card
    equal to the CPU."""
    ranks = torch.arange(8, dtype=torch.float32)
    zeros = torch.zeros(8)
    expect = {
        AsyncMode.BARRIER_EVERY_STEP: (ranks.roll(1), (ranks + 100).roll(1)),
        AsyncMode.BEST_EFFORT: (zeros, ranks.roll(1)),
        AsyncMode.NO_COMM: (zeros, zeros),
        AsyncMode.ROLLING_BARRIER: (zeros, (ranks + 100).roll(1)),
        AsyncMode.FIXED_BARRIER: (zeros, (ranks + 100).roll(1)),
    }
    for mode, want in expect.items():
        card = ring_exchanges(mode, "cuda")
        cpu = ring_exchanges(mode, "cpu")
        check(all(x.is_cuda for x in card), f"conduit {mode}: not on the card")
        for i, (g, w) in enumerate(zip(card, want)):
            check(torch.equal(g.cpu(), w),
                  f"conduit {mode} exchange {i + 1}: {g.tolist()} != "
                  f"{w.tolist()}")
        for g, c in zip(card, cpu):
            check(torch.equal(g.cpu(), c), f"conduit {mode}: card != CPU")
    print("conduits on an 8-long ring, modes 0-4: the reference's staleness "
          "semantics on the card, card == CPU", flush=True)


def collectives_on_card():
    """(b) ``exchange_gradients`` at 2 pods, modes 0-4, two steps each,
    with ``test_gradient_exchange_modes``' values; ``cross_pod_sum`` with
    int8 and with top-k on a real-width leaf, card == CPU bitwise.
    Returns the compression kernels' launches in those sums."""
    g = torch.tensor([1.0, 3.0], device="cuda")
    expect = {AsyncMode.BARRIER_EVERY_STEP: ([2.0, 2.0], [20.0, 20.0]),
              AsyncMode.BEST_EFFORT: ([0.5, 1.5], [6.5, 15.5])}
    for mode in AsyncMode:
        st = collectives.init_exchange_state(g, mode)
        e1, st = collectives.exchange_gradients(g, st, mode)
        e2, st = collectives.exchange_gradients(g * 10, st, mode)
        want = expect.get(mode, ([1.0, 3.0], [10.0, 30.0]))
        check(e1.is_cuda and (e1.tolist(), e2.tolist()) == want,
              f"exchange_gradients {mode}: {e1.tolist()}, {e2.tolist()}, "
              f"expected {want}")
    print("exchange_gradients at 2 pods, modes 0-4, two steps: the "
          "reference's values on the card", flush=True)
    gen = torch.Generator().manual_seed(20)
    leaf = torch.randn(SPMD_LEAF, generator=gen) * 10.0 ** (
        -6 * torch.rand(SPMD_LEAF[:2] + (1,), generator=gen))
    launched = {}
    for comp in (Int8Compressor(), TopKCompressor()):
        res_cpu = torch.zeros_like(leaf)
        res_card = res_cpu.cuda()
        want, _ = collectives.cross_pod_sum(leaf, 0, comp, res_cpu)
        K.reset_launches()
        got, _ = collectives.cross_pod_sum(leaf.cuda(), 0, comp, res_card)
        torch.cuda.synchronize()
        used = {k: v for k, v in K.LAUNCHES.items() if v}
        launched.update(used)
        name = type(comp).__name__
        check(torch.equal(got.cpu(), want) and torch.equal(res_card.cpu(),
                                                           res_cpu),
              f"cross_pod_sum {name}: card != CPU")
        check(tuple(got.shape) == SPMD_LEAF and got.stride(0) == 0,
              f"cross_pod_sum {name}: total {tuple(got.shape)}")
        print(f"cross_pod_sum {name} on {SPMD_LEAF}: card == CPU bitwise "
              f"(total and residuals); launches {used}", flush=True)
    check(launched == {"quantize": 2, "dequantize": 2, "topk_compress": 2},
          f"cross_pod_sum launches {launched}")
    return launched


def spmd_run(mode, flush_every, steps, mesh_shape, block, dev, seed=0):
    """``steps`` of ``spmd_step`` on ``dev``; returns (state, conflicts
    (steps, R, C) int32, wall s)."""
    rowc, colc = conduit.torus_conduits(("row", "col"), mode)
    state = graphcolor.init_spmd_state(mesh_shape, block, SPMD_COLORS, rowc,
                                       colc, seed=seed, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    confs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        flush = (None if flush_every is None else
                 (state["step"] % flush_every) == flush_every - 1)
        state, conf = graphcolor.spmd_step(state, rowc, colc, SPMD_B,
                                           flush=flush)
        confs.append(conf)
    confs = torch.stack(confs)
    if dev == "cuda":
        torch.cuda.synchronize()
    return state, confs, time.perf_counter() - t0, (rowc, colc)


def spmd_profile(state, conduits, flush_every, steps):
    """torch.profiler over ``steps`` more steps (after one profiled step
    that warms the profiler up): CUDA launches and device busy ms a step
    and the busy share of the profiled wall time."""
    rowc, colc = conduits
    for n in (1, steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                flush = (None if flush_every is None else
                         (state["step"] % flush_every) == flush_every - 1)
                state, _ = graphcolor.spmd_step(state, rowc, colc, SPMD_B,
                                                flush=flush)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return profile_serve._summary(prof, wall, steps, "spmd_step")


def spmd_breakdown(state, conduits):
    """Where a best-effort step's device time goes at full size: the whole
    step, its draws (``spmd_uniforms``) and its update (``update_block``
    on given draws and halos), each timed alone (``device_ms``); the rest
    is the exchange and the payloads."""
    rowc, colc = conduits
    shape = tuple(state["colors"].shape)
    u = graphcolor.spmd_uniforms(state["key"], state["step"], shape, "cuda")
    halo = {k: state["colors"][..., 0, :] for k in ("n", "s")}
    halo.update({k: state["colors"][..., :, 0] for k in ("w", "e")})
    parts = {
        "step": lambda: graphcolor.spmd_step(state, rowc, colc, SPMD_B),
        "draws": lambda: graphcolor.spmd_uniforms(
            state["key"], state["step"], shape, "cuda"),
        "update": lambda: graphcolor.update_block(
            state["colors"], state["probs"], halo, SPMD_B, u),
    }
    ms = {k: device_ms(fn, runs=10)[0] for k, fn in parts.items()}
    rest = ms["step"] - ms["draws"] - ms["update"]
    print(f"spmd mode 3 device ms a step: whole {ms['step']:.4f}, draws "
          f"{ms['draws']:.4f} ({ms['draws'] / ms['step']:.1%}), update "
          f"{ms['update']:.4f} ({ms['update'] / ms['step']:.1%}), exchange "
          f"and the rest {rest:.4f}", flush=True)


def spmd_graphcolor():
    """(c) graph coloring's SPMD step at full size: a (16, 16) mesh of
    256 x 256 blocks (16.8 M nodes, 3 colors, b = 0.1).  The first
    SPMD_CHECK_STEPS best-effort steps on the card equal the CPU's
    bitwise; then SPMD_STEPS steps in modes 0, 3, 4 and 1 (flush every 8
    steps), each timed and profiled; best effort must end with fewer
    conflicts than it started with.  Then the reference's own size (2 x 2
    of 16 x 16, 400 steps): best effort meets its criterion on the card."""
    nodes = math.prod(SPMD_MESH) * math.prod(SPMD_BLOCK)
    card = spmd_run(AsyncMode.BEST_EFFORT, None, SPMD_CHECK_STEPS,
                    SPMD_MESH, SPMD_BLOCK, "cuda")
    cpu = spmd_run(AsyncMode.BEST_EFFORT, None, SPMD_CHECK_STEPS,
                   SPMD_MESH, SPMD_BLOCK, "cpu")
    for k in ("colors", "probs", "step"):
        check(torch.equal(card[0][k].cpu(), cpu[0][k]),
              f"spmd_step: {k} differs between card and CPU")
    check(torch.equal(card[1].cpu(), cpu[1]),
          "spmd_step: conflicts differ between card and CPU")
    print(f"spmd graph coloring {SPMD_MESH} x {SPMD_BLOCK} ({nodes:,} "
          f"nodes): {SPMD_CHECK_STEPS} best-effort steps card == CPU "
          f"bitwise (colors, probs, conflicts; CPU {cpu[2]:.1f} s)",
          flush=True)
    out = {}
    for label, mode, flush_every in SPMD_RUNS:
        state, confs, wall, conds = spmd_run(mode, flush_every, SPMD_STEPS,
                                             SPMD_MESH, SPMD_BLOCK, "cuda")
        per_dev = confs.double()
        start = float(per_dev[:10].mean())
        end = float(per_dev[-10:].mean())
        prof = spmd_profile(state, conds, flush_every, SPMD_PROFILE_STEPS)
        out[label] = rec = dict(
            ms_per_step=wall * 1e3 / SPMD_STEPS,
            node_updates_per_s=nodes * SPMD_STEPS / wall,
            launches_per_step=prof["kernel_launches_per_call"],
            device_busy_ms_per_step=prof["device_busy_ms_per_call"],
            device_busy_share=prof["device_busy_share"],
            conflicts_first10=start, conflicts_last10=end)
        print(f"spmd {label}: {rec['ms_per_step']:.4f} ms a step, "
              f"{rec['node_updates_per_s']:.4g} node updates/s, "
              f"{rec['launches_per_step']:.1f} CUDA launches a step, device "
              f"busy {rec['device_busy_ms_per_step']:.4f} ms a step "
              f"({rec['device_busy_ms_per_step'] / rec['ms_per_step']:.1%} "
              f"of the unprofiled step, {rec['device_busy_share']:.1%} of "
              f"the profiled wall {prof['wall_ms_per_call']:.4f} ms), "
              f"conflicts a device first 10 steps {start:.1f}, last 10 "
              f"{end:.1f}", flush=True)
        if label == "mode 3":
            top = ", ".join(
                f"{k['name'][:60]} x{k['launches'] / SPMD_PROFILE_STEPS:g} "
                f"{k['ms_per_call']:.4f} ms" for k in prof["top_kernels"][:5])
            print(f"spmd {label}: top kernels a step: {top}", flush=True)
            spmd_breakdown(state, conds)
    be = out["mode 3"]
    check(be["conflicts_last10"] < be["conflicts_first10"],
          f"spmd best effort did not reduce conflicts: {be}")
    _, confs, wall, _ = spmd_run(AsyncMode.BEST_EFFORT, None, 400, (2, 2),
                                 (16, 16), "cuda")
    start, end = float(confs[:10].double().mean()), \
        float(confs[-10:].double().mean())
    check(end < 0.3 * start,
          f"spmd at the reference's size: last 10 {end} >= 0.3 x first 10 "
          f"{start}")
    print(f"spmd at the reference's size (2 x 2 of 16 x 16, 400 steps, best "
          f"effort): conflicts a device {start:.2f} -> {end:.2f} (< 0.3 x), "
          f"{wall * 1e3 / 400:.4f} ms a step", flush=True)
    return out


@phase("spmd")
def spmd():
    """The SPMD tools on the card: (a) the conduits, (b) the collectives,
    (c) graph coloring's spmd_step at full size.  Returns the compression
    kernels' launches in (b)."""
    conduits_on_card()
    launched = collectives_on_card()
    spmd_graphcolor()
    return launched


#: each kernel entry point of the kernels JSON line: (name, kernel source
#: key, TPU kernel it replaces)
ENTRIES = (
    ("duct_window", "duct_window",
     "src/repro/kernels/duct_exchange/kernel.py:81"),
    ("duct_window_f32", "duct_window",
     "src/repro/kernels/duct_exchange/kernel.py:81"),
    ("duct_commit", "duct_commit",
     "src/repro/kernels/duct_exchange/kernel.py:197"),
    ("duct_commit_f32", "duct_commit",
     "src/repro/kernels/duct_exchange/kernel.py:197"),
    ("duct_exchange", "duct_exchange",
     "src/repro/kernels/duct_exchange/kernel.py:31"),
    ("duct_exchange_drain", "duct_exchange",
     "src/repro/kernels/duct_exchange/kernel.py:31"),
    ("duct_exchange_send", "duct_exchange",
     "src/repro/kernels/duct_exchange/kernel.py:31"),
    ("flash_attention", "flash_attention",
     "src/repro/kernels/flash_attention/kernel.py:20"),
    ("flash_attention_f32", "flash_attention",
     "src/repro/kernels/flash_attention/kernel.py:20"),
    ("decode_attention", "decode_attention",
     "src/repro/kernels/decode_attention/kernel.py:19"),
    ("quantize", "quantize", "src/repro/kernels/quantize/kernel.py:16"),
    ("dequantize", "dequantize", "src/repro/kernels/quantize/kernel.py:23"),
    ("topk_compress", "topk_compress",
     "src/repro/kernels/topk_compress/kernel.py:17"),
    ("mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan/kernel.py:23"),
    ("mlstm_attention", "mlstm_attention",
     "src/repro/kernels/mlstm_attention/kernel.py:26"),
    ("mlstm_attention_f32", "mlstm_attention",
     "src/repro/kernels/mlstm_attention/kernel.py:26"),
    ("mamba_scan_backward", "mamba_scan_backward",
     "no Pallas backward: the gradient of "
     "src/repro/kernels/mamba_scan/ref.py:8 mamba_scan_ref"),
    ("mlstm_attention_backward", "mlstm_attention_backward",
     "no Pallas backward: the gradient of "
     "src/repro/kernels/mlstm_attention/ref.py:8 mlstm_attention_ref"),
    ("mlstm_attention_backward_f32", "mlstm_attention_backward",
     "no Pallas backward: the gradient of "
     "src/repro/kernels/mlstm_attention/ref.py:8 mlstm_attention_ref"),
)


# ---------------------------------------------------------------------------
# 21. batched replicates
# ---------------------------------------------------------------------------
#: (a): the documented weak-scaling sweep (``--procs 256 --replicates 32``,
#: EXPERIMENTS.md), cut from 0.05 virtual s to 0.00025 so that its
#: sequential loop (32 runs, each launch-bound) fits the phase; that loop
#: probes every 16 windows (a probe's place does not change a result)
SWEEP = dict(procs=256, replicates=32, duration=0.00025, sequential_chunk=16)
#: (a): seeds of phase 4's lossy 16-process torus that stop in different
#: windows at 2**-8 virtual s (237 and 236), run one window a chunk so
#: that the done probe reads each stop
STAGGERED = dict(seeds=(0, 6), duration=2.0 ** -8)
#: (b): phase 6's graph coloring at R replicates, and its duration (cut
#: from 0.02 for the script's time: one chunk)
BATCH_R, BATCH_DEPTH = 8, 0.0025
#: (c): the sharded batch: R, duration (cut from 0.02), chunk
SHARDED_BATCH = dict(replicates=4, duration=0.0025, chunk=64)


def result_bits(x):
    """A SimResult (any nest of dataclasses, dicts, lists, arrays and
    numbers) as a comparable value, floats as their IEEE bits."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, result_bits(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple((k, result_bits(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(result_bits(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, float):
        return struct.pack("<d", x)
    return x


def same_results(label, want, got):
    check(len(want) == len(got), f"{label}: {len(got)} results")
    for r, (a, b) in enumerate(zip(want, got)):
        check(result_bits(a) == result_bits(b),
              f"{label}: replicate {r} differs")


def batch_run(label, eng, seeds, sequential=False):
    """``eng.run_replicates(seeds)`` (or the sequential loop), launch
    counters zeroed just before and read just after: (results, wall s,
    windows executed in all, duct launches)."""
    torch.cuda.synchronize()
    K.reset_launches()
    done = len(eng.windows)
    t0 = time.perf_counter()
    res = (eng.run_replicates_sequential(seeds) if sequential
           else eng.run_replicates(seeds))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a batch executes its windows once for all; the loop once a seed
    windows = (sum(eng.windows[done:]) if sequential else eng.windows[-1])
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    duct = sum(launches.values())
    check(duct > 0, f"{label}: no duct launches")
    updates = sum(sum(r.updates) for r in res)
    print(f"replicates {label}: {len(seeds)} seeds, {wall:.2f}s wall, "
          f"{windows} windows, {wall * 1e3 / windows:.3f} ms a window, "
          f"{updates} updates, {updates / wall:.0f} updates/s, "
          f"{duct / windows:.3f} duct launches a window {launches}",
          flush=True)
    return res, wall, windows, launches


def window_profile(argv):
    """``profile_window`` over 8 windows: CUDA launches, duct launches,
    device busy ms and busy share a window."""
    out = profile_window.main(["--windows", "8", *argv])
    return (f"{out['kernel_launches_per_window']:.1f} CUDA launches and "
            f"{out['duct_launches_per_window']:.3f} duct launches a window, "
            f"device busy {out['device_busy_ms_per_window']:.4f} ms a "
            f"window, {100 * out['device_busy_share']:.1f}% busy "
            f"(profiler on: {out['wall_ms_per_window']:.3f} ms a window)"), out


def replicate_sweep():
    """(a) The sweep through the CLI (``experiments.main``), its batched
    results captured; the same seeds through the sequential loop; every
    SimResult field equal; wall, duct launches a window and busy share of
    both."""
    argv = ["--engine", "torch", "--device", "cuda", "--topology", "torus",
            "--procs", str(SWEEP["procs"]), "--replicates",
            str(SWEEP["replicates"]), "--duration", str(SWEEP["duration"])]
    captured = []
    real = engine_torch.TorchEngine.run_replicates

    def capture(eng, seeds):
        out = real(eng, seeds)
        captured.append((eng, list(seeds), out))
        return out

    torch.cuda.synchronize()
    K.reset_launches()
    engine_torch.TorchEngine.run_replicates = capture
    try:
        t0 = time.perf_counter()
        rows = experiments.main(argv)
        cli_wall = time.perf_counter() - t0
    finally:
        engine_torch.TorchEngine.run_replicates = real
    check(len(captured) == 1 and rows[0]["replicates"] ==
          SWEEP["replicates"], f"sweep: {len(captured)} batches")
    eng, seeds, batched = captured[0]
    windows = eng.windows[-1]
    duct = sum(K.LAUNCHES.values())
    check(duct == windows, f"sweep: {duct} duct launches in {windows} "
          "windows of one batch")
    print(f"replicates sweep batched (CLI): {len(seeds)} seeds x "
          f"{SWEEP['procs']} processes in one carry, {cli_wall:.2f}s wall, "
          f"{windows} windows, {duct / windows:.3f} duct launches a window, "
          f"{rows[0]['updates']} updates", flush=True)
    args = experiments.build_parser().parse_args(argv)
    seq_eng = make_engine(RunConfig.from_args(args), experiments.make_app(
        "graphcolor", SWEEP["procs"], 1, make_topology("torus",
                                                       SWEEP["procs"]),
        args.seed), experiments._sim_config(args, SWEEP["procs"]),
        chunk=SWEEP["sequential_chunk"], device="cuda")
    seq, seq_wall, seq_windows, seq_launches = batch_run(
        "sweep sequential", seq_eng, seeds, sequential=True)
    same_results("sweep: batched vs sequential", seq, batched)
    print(f"replicates sweep: batched == sequential, every SimResult field "
          f"of {len(seeds)} seeds (quality included); wall {cli_wall:.2f}s "
          f"batched, {seq_wall:.2f}s sequential", flush=True)
    procs = ["--procs", str(SWEEP["procs"])]
    for r in (SWEEP["replicates"], 1):
        line, _ = window_profile([*procs, "--replicates", str(r)])
        print(f"replicates sweep R={r}: {line}", flush=True)


def replicate_staggered():
    """(a) Replicates that stop in different chunks, on the card: the
    batch's ``windows_needed`` differ, the batch runs as many windows as
    its last replicate needs, and each replicate equals its own run, every
    SimResult field and its windows needed."""
    topology = "torus"
    seed = case_seed(topology)
    cfg = dyadic_cfg(seed=seed, duration=STAGGERED["duration"],
                     carry_app_state=True)

    def engine():
        return make_engine(RunConfig(engine="torch"),
                           gc_app(16, topology, seed), cfg,
                           lossy_host(make_topology(topology, 16), 0, 0.25),
                           max_pops=EXACT_MAX_POPS, chunk=1, device="cuda")

    seeds = list(STAGGERED["seeds"])
    eng = engine()
    batched = eng.run_replicates(seeds)
    needed = eng.windows_needed[-len(seeds):]
    check(len(set(needed)) == len(seeds) and max(needed) == eng.windows[-1],
          f"staggered: windows needed {needed}, {eng.windows[-1]} run")
    single = engine()
    for r, s in enumerate(seeds):
        same_results(f"staggered seed {s}", single.run_replicates([s]),
                     [batched[r]])
        check(single.windows_needed[-1] == needed[r],
              f"staggered seed {s}: {single.windows_needed[-1]} windows "
              f"needed alone, {needed[r]} in the batch")
    print(f"replicates staggered lossy torus-16 seeds {seeds}: windows "
          f"needed {needed} in one batch of {eng.windows[-1]} windows (one "
          "a chunk); each replicate == its own run, every SimResult field",
          flush=True)


def batched_shapes(hbm):
    """The duct kernels at the shapes one launch covers in (b) and (c):
    each through its replicate fold, against its plain version (bitwise),
    with its time and its bound at that shape."""
    dev, rng = torch.device("cuda"), np.random.default_rng(27)
    R, n, d, C, L, W, pops = BATCH_R, 4096, 4, 64, 1, 8, 16
    args = [x.reshape((R, n) + tuple(x.shape[1:]))
            for x in window_state(rng, R * n, d, C, L, 64, dev)]
    measure(f"replicates duct_window R={R} x (4096, 4, 64, 1)",
            lambda: duct_window(*args, max_pops=pops),
            lambda: duct_window_torch(*args, max_pops=pops), args,
            R * n * d * C * (8 + 2 * L), hbm)
    rows = n * d
    flat = commit_state(rng, R * rows, C, L, W, dev)
    args = [x.reshape((R, rows) + tuple(x.shape[1:])) for x in flat]
    measure(f"replicates duct_commit R={R} x (16384 rows, W=8)",
            lambda: duct_commit(*args), lambda: duct_commit_torch(*args),
            args, R * rows * C * (6 + L), hbm, read=commit_read(flat))
    R = SHARDED_BATCH["replicates"]
    flat = exchange_state(rng, R * rows, C, dev)
    args = [x.reshape((R, rows) + tuple(x.shape[1:])) for x in flat]
    measure(f"replicates duct_exchange drain R={R} x (16384, 64)",
            lambda: duct_drain(*args[:6], max_pops=pops),
            lambda: duct_drain_torch(*args[:6], max_pops=pops), args[:6],
            R * rows * C * 10, hbm, **drain_bytes(flat, pops))
    measure(f"replicates duct_exchange send R={R} x (16384, 64)",
            lambda: duct_send(*args[:4], *args[6:], capacity=C),
            lambda: duct_send_torch(*args[:4], *args[6:], capacity=C),
            args[:4] + args[6:], R * rows * C * 10, hbm)


def replicate_full_width():
    """(b) Phase 6's graph coloring at BATCH_R replicates, dense window and
    W = 8 (BATCH_DEPTH): duct launches a window equal phase 6's (R = 1), ms a
    window and updates/s summed over replicates beside phase 6's; card ==
    CPU at R = 3 on a reduced size, graph coloring (int32) and evo
    (float32).  Returns the duct entries' launches."""
    launched = {}
    seeds = list(range(BATCH_R))
    # both batches at BATCH_DEPTH (cut from 0.02 for the script's time):
    # their launches a window are compared, not their results
    for label, kw, used, depth in (
            ("window", {}, "duct_window", BATCH_DEPTH),
            ("superstep8", {"superstep_windows": 8}, "duct_commit",
             BATCH_DEPTH)):
        base = f"graphcolor torus-4096 {label}"
        if base not in DRIVEN:
            drive(base, "graphcolor", 4096, 1, 0.02, kw)
        one = DRIVEN[base]
        eng, _ = drive_engine("graphcolor", 4096, 1, depth, kw)
        res, wall, windows, launches = batch_run(f"{base} R={BATCH_R}", eng,
                                                 seeds)
        for name in set(launches) | set(one["launches"]):
            per = launches.get(name, 0) / windows
            per1 = one["launches"].get(name, 0) / one["windows"]
            check(per == per1, f"{base} R={BATCH_R}: {name} {per} launches "
                  f"a window, R=1 {per1}")
        launched[used] = launches[used]
        updates = sum(sum(r.updates) for r in res)
        print(f"replicates {base}: R={BATCH_R} {wall * 1e3 / windows:.3f} "
              f"ms a window, {updates / wall:.0f} updates/s summed over "
              f"replicates; R=1 (phase 6) "
              f"{one['wall'] * 1e3 / one['windows']:.3f} ms a window, "
              f"{one['updates'] / one['wall']:.0f} updates/s", flush=True)
    for app_name, n, simels in (("graphcolor", 256, 1), ("evo", 64, 64)):
        seed = case_seed("torus")
        cfg = dyadic_cfg(seed=seed, duration=CARD_CPU_DURATION)
        out = {}
        for device in ("cuda", "cpu"):
            K.reset_launches()
            out[device] = make_engine(
                RunConfig(engine="torch"),
                experiments.make_app(app_name, n, simels,
                                              make_topology("torus", n),
                                              seed), cfg, chunk=64,
                device=device).run_replicates([seed, seed + 1, seed + 2])
            launched_here = sum(K.LAUNCHES.values())
            check((launched_here > 0) == (device == "cuda"),
                  f"{app_name} R=3 on {device}: {launched_here} launches")
            if device == "cuda":
                count_service_launches(launched, app_name)
        same_results(f"{app_name} torus-{n} R=3 card vs CPU", out["cpu"],
                     out["cuda"])
        print(f"replicates {app_name} torus-{n} simels={simels} R=3: card "
              f"== CPU, every SimResult field", flush=True)
    return launched


def replicate_sharded():
    """(c) torus-4096 at SHARDED_BATCH's R and duration: 8 shards batched
    == unsharded batched, every SimResult field."""
    seeds = list(range(SHARDED_BATCH["replicates"]))
    out = {}
    for label, kw in (("unsharded", {}), ("8 shards", {"shards": 8})):
        eng, _ = drive_engine("graphcolor", 4096, 1,
                              SHARDED_BATCH["duration"], kw,
                              chunk=SHARDED_BATCH["chunk"])
        out[label] = batch_run(f"graphcolor torus-4096 {label} "
                               f"R={len(seeds)}", eng, seeds)[0]
    same_results("torus-4096 8 shards vs unsharded", out["unsharded"],
                 out["8 shards"])
    print(f"replicates torus-4096 R={len(seeds)}: 8 shards == unsharded, "
          f"every SimResult field", flush=True)


@phase("replicates")
def replicates(hbm):
    """Batched replicates on the card: (a) the weak-scaling sweep and
    replicates that stop in different chunks, (b) the
    full-width batch, (c) the sharded batch, then the duct kernels at the
    shapes one launch covers there.  Returns the duct entries' launches in
    (b)."""
    replicate_sweep()
    replicate_staggered()
    launched = replicate_full_width()
    replicate_sharded()
    batched_shapes(hbm)
    return launched


# ---------------------------------------------------------------------------
# 22. the shard axis over torch.distributed ranks
# ---------------------------------------------------------------------------
#: (label, RunConfig fields, duration, mode, chunk) of the engine runs over
#: ranks: phase 18's 8-shard window and W=8 pipelined runs at
#: SHARDED_DEPTH, and a barrier run (every window a release all-reduced
#: over the ranks), probed every 64 windows
RANK_RUNS = (
    ("8 shards window short", {"shards": 8}, SHARDED_DEPTH,
     AsyncMode.BEST_EFFORT, 256),
    ("8 shards pipelined8", {"shards": 8, "superstep_windows": 8,
                             "scheduler": "pipelined"}, SHARDED_DEPTH,
     AsyncMode.BEST_EFFORT, 256),
    ("8 shards window barrier", {"shards": 8}, 0.00125,
     AsyncMode.BARRIER_EVERY_STEP, 64))
#: gloo ranks sharing the card, and the SPMD steps over them
RANK_WORLD, RANK_SPMD_STEPS = 2, 20
#: the one-process runs whose SimResults phase 22 holds the ranks to
#: (``drive`` keeps no other run's result)
RANK_HELD = {"graphcolor torus-4096 " + run[0] for run in RANK_RUNS}


def digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def rank_drive(label, kw, duration, mode, chunk, backend):
    """One engine run of ``RANK_RUNS`` with its shards over this process's
    ranks (the process group is up), launch counters and the group's
    stats zeroed just before the run and read just after it."""
    group = mesh.make_shard_mesh(kw["shards"], backend, device="cuda")
    eng, _ = drive_engine("graphcolor", 4096, 1, duration, kw, chunk=chunk,
                          mode=mode, group=group)
    torch.cuda.synchronize()
    K.reset_launches()
    group.reset_stats()
    group.time_device = True
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(result=res, wall=wall, windows=eng.windows[-1],
                needed=eng.windows_needed[-1], launches=dict(K.LAUNCHES),
                stats=dict(group.stats), hop_device_ms=group.hop_device_ms())


def rank_spmd(steps):
    """``steps`` best-effort ``spmd_step``s on phase 20's mesh, its rows
    over this process's gloo ranks: digests of this rank's colors,
    probabilities and conflicts, and the wall s."""
    group = mesh.make_shard_mesh(SPMD_MESH[0], "gloo", device="cuda")
    rowc, colc = conduit.torus_conduits(("row", "col"),
                                        AsyncMode.BEST_EFFORT, group)
    state = graphcolor.init_spmd_state(SPMD_MESH, SPMD_BLOCK, SPMD_COLORS,
                                       rowc, colc, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    confs = []
    for _ in range(steps):
        state, conf = graphcolor.spmd_step(state, rowc, colc, SPMD_B)
        confs.append(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(colors=digest(state["colors"]), probs=digest(state["probs"]),
                conflicts=digest(torch.stack(confs)), wall=wall,
                stats=dict(group.stats))


def rank_main(rank, world, store, out_dir):
    """A gloo rank on the card: every ``RANK_RUNS`` run, then the SPMD
    steps; what it measured goes to ``out_dir``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        out = {run[0]: rank_drive(*run, "gloo") for run in RANK_RUNS}
        out["spmd"] = rank_spmd(RANK_SPMD_STEPS)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def rank_report(label, how, rank, got, one):
    """The measured line of one rank's run beside the one-process run's
    (``one``, from ``DRIVEN``)."""
    w, st = got["windows"], got["stats"]
    print(f"ranks {label} {how} rank {rank}: {got['wall'] * 1e3 / w:.3f} ms "
          f"a window (one process {one['wall'] * 1e3 / one['windows']:.3f}), "
          f"{got['launches']['duct_exchange'] / w:.3f} duct launches a "
          f"window (one process "
          f"{one['launches']['duct_exchange'] / one['windows']:.3f}), "
          f"{w} windows, {got['needed']} needed, {st['hops'] / w:.3f} hops "
          f"in {st['exchanges'] / w:.3f} exchanges a window, hop host "
          f"{st['hop_s'] * 1e3 / w:.4f} ms and device "
          f"{got['hop_device_ms'] / w:.4f} ms a window, "
          f"{st['hop_bytes'] / max(st['hops'], 1):.0f} bytes to peers a "
          f"hop, {st['all_reduces'] / w:.4f} all-reduces a window "
          f"({st['all_reduce_s'] * 1e3 / w:.4f} host ms a window), "
          f"{st['all_gathers']} all-gathers", flush=True)


@phase("ranks")
def ranks():
    """The shard axis over torch.distributed ranks on the one card.  (a)
    ``RANK_RUNS`` over 2 gloo ranks sharing the card (spawned here; the
    boundary buffers and the release reductions staged through pinned
    host memory): every SimResult field of every rank equals the
    one-process 8-shard run's (phase 18's window and pipelined runs, and a
    barrier run made here); (b) the same over 1 NCCL rank (in this
    process); (c) phase 20's (16, 16) mesh of 256 x 256 blocks, its rows
    over the 2 gloo ranks: ``RANK_SPMD_STEPS`` best-effort steps equal
    one process's state bitwise; (d) each run's ms a window, duct
    launches a window, the hops' host and device ms a window and the
    all-reduces a window on each rank, beside the one-process run's."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    label, kw, duration, mode, chunk = RANK_RUNS[2]
    drive("graphcolor torus-4096 " + label, "graphcolor", 4096, 1, duration,
          kw, chunk, mode)
    one = {label: DRIVEN["graphcolor torus-4096 " + label]
           for label, *_ in RANK_RUNS}
    spmd_one, confs, _, _ = spmd_run(AsyncMode.BEST_EFFORT, None,
                                     RANK_SPMD_STEPS, SPMD_MESH, SPMD_BLOCK,
                                     "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(rank_main, args=(RANK_WORLD,
                                            os.path.join(tmp, "store"), tmp),
                           nprocs=RANK_WORLD, join=True,
                           start_method="spawn")
        spawned = time.perf_counter() - t0
        got = []
        for r in range(RANK_WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
    for label, *_ in RANK_RUNS:
        for r, out in enumerate(got):
            same_results(f"ranks {label} gloo rank {r}",
                         [one[label]["result"]], [out[label]["result"]])
            check(out[label]["stats"]["hops"] > 0 and
                  out[label]["launches"]["duct_exchange"] > 0,
                  f"ranks {label} gloo rank {r}: {out[label]['stats']}")
            rank_report(label, f"{RANK_WORLD} gloo ranks", r, out[label],
                        one[label])
        print(f"ranks {label}: {RANK_WORLD} gloo ranks == one process "
              "(every SimResult field, every rank)", flush=True)
    per = SPMD_MESH[0] // RANK_WORLD
    for r, out in enumerate(got):
        rows = slice(r * per, (r + 1) * per)
        want = dict(colors=digest(spmd_one["colors"][rows]),
                    probs=digest(spmd_one["probs"][rows]),
                    conflicts=digest(confs[:, rows]))
        for k, v in want.items():
            check(out["spmd"][k] == v, f"ranks spmd rank {r}: {k} differs")
        st = out["spmd"]["stats"]
        print(f"ranks spmd {SPMD_MESH} x {SPMD_BLOCK} rank {r}: "
              f"{RANK_SPMD_STEPS} best-effort steps == one process (colors, "
              f"probs, conflicts), "
              f"{out['spmd']['wall'] * 1e3 / RANK_SPMD_STEPS:.3f} ms a step, {st['hops'] / RANK_SPMD_STEPS:.1f} hops in "
              f"{st['exchanges'] / RANK_SPMD_STEPS:.1f} exchanges a step, "
              f"hop host {st['hop_s'] * 1e3 / RANK_SPMD_STEPS:.3f} ms a step",
              flush=True)
    print(f"ranks: {RANK_WORLD} gloo ranks spawned, ran and joined in "
          f"{spawned:.1f}s", flush=True)
    # (b) one NCCL rank: the collectives run, the hops are rolls
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl",
                                init_method="file://" + os.path.join(
                                    tmp, "store"), rank=0, world_size=1)
        try:
            for run in RANK_RUNS[:2]:
                label = run[0]
                out = rank_drive(*run, "nccl")
                same_results(f"ranks {label} nccl", [one[label]["result"]],
                             [out["result"]])
                check(out["stats"]["all_gathers"] > 0,
                      f"ranks {label} nccl: {out['stats']}")
                rank_report(label, "1 nccl rank", 0, out, one[label])
                print(f"ranks {label}: 1 nccl rank == one process (every "
                      "SimResult field)", flush=True)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 23. training's pod axis over torch.distributed ranks
# ---------------------------------------------------------------------------
#: qwen3-0.6b uncut (28 layers, d 1024; bf16 compute, float32 masters),
#: batch 4 x 2048 over 2 pods, TRAIN_RANKS_STEPS steps of each mode: the
#: CLI's spec (lr 3e-3, 20 warmup steps).  Cut in steps, 4 -> 3, to hold
#: the phase near 90 s: alone it took 125.0 s at 4 steps on an H100 80GB
#: HBM3 (700 W), 78 s of them in the 2 gloo ranks, whose mode-0 step
#: stages 2.38 GB a rank through the host (6.8 s a step)
TRAIN_RANKS_ARCH, TRAIN_RANKS_PODS = "qwen3-0.6b", 2
TRAIN_RANKS_B, TRAIN_RANKS_S, TRAIN_RANKS_STEPS = 4, 2048, 3
TRAIN_RANKS_MODES = ((0, None), (3, "int8"), (3, "topk"))


def fingerprint(x: torch.Tensor) -> int:
    """A bitwise fingerprint of a float32 tensor, made on its device: its
    bits as int64, weighted by position (1 .. 65536, cycling) and summed
    modulo 2**64.  One differing element changes it."""
    bits = x.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel(), device=x.device) % 65536 + 1
    return int((bits * w).sum())


def train_ranks_run(mode, comp, group=None):
    """``TRAIN_RANKS_STEPS`` steps of ``run_training`` in ``mode`` with
    ``comp`` at n_pods = 2, over ``group`` (this rank's pods) or in one
    process; launch counters, routes and the group's stats zeroed just
    before and read just after.  Returns the history, the launches and
    routes, the peak memory and each pod's final parameter fingerprints
    {(path, pod): int}."""
    cfg = train.resolve_config(TRAIN_RANKS_ARCH)
    spec = train.TrainSpec(
        mode=AsyncMode(mode), compressor=comp,
        adamw=AdamWConfig(lr=3e-3, warmup_steps=20,
                          total_steps=TRAIN_RANKS_STEPS))
    data = DataConfig(cfg.vocab_size, TRAIN_RANKS_S, TRAIN_RANKS_B, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    K.reset_launches()
    if group is not None:
        group.reset_stats()
    state, history = train.run_training(
        cfg, spec, data, steps=TRAIN_RANKS_STEPS, n_pods=TRAIN_RANKS_PODS,
        log_every=1, log=lambda _: None, device="cuda", seed=0, group=group)
    torch.cuda.synchronize()
    out = dict(history=history, launches=dict(K.LAUNCHES),
               routes=dict(K.ROUTES),
               peak=torch.cuda.max_memory_allocated(),
               leaves=len(state["params"]),
               topk_routes=leaf_topk_routes(state["params"], 1))
    lo = 0 if group is None else group.lo
    out["params"] = {(k, lo + p): fingerprint(v[p])
                     for k, v in state["params"].items()
                     for p in range(v.shape[0])}
    del state
    torch.cuda.empty_cache()
    return out


def train_ranks_launches(cfg, got, pods):
    """The launches and routes of a run holding ``pods`` of the
    ``TRAIN_RANKS_PODS`` pods: flash_attention forward and recompute per
    attention layer per pod-step on the tensor-core route; per leaf per
    pod-step one quantize and one topk_compress (by its route); per leaf
    per step one dequantize for every pod's payload."""
    steps = TRAIN_RANKS_STEPS
    want = train_launches(cfg, steps * pods)
    routes = {"flash_attention/wgmma": want["flash_attention"]}
    mode, comp = got["case"]
    if comp == "int8":
        want["quantize"] = got["leaves"] * steps * pods
        want["dequantize"] = got["leaves"] * steps * TRAIN_RANKS_PODS
    elif comp == "topk":
        want["topk_compress"] = got["leaves"] * steps * pods
        routes.update({k: v * steps * pods
                       for k, v in got["topk_routes"].items()})
    return want, routes


def train_rank_main(rank, world, store, out_dir):
    """A gloo rank on the card holding 1 of the 2 pods: every
    ``TRAIN_RANKS_MODES`` run, then its pod's step-1 gradient payload
    through the compression kernels (rank 0); what it measured goes to
    ``out_dir``."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        group = mesh.make_shard_mesh(TRAIN_RANKS_PODS, "gloo", device="cuda")
        out = {}
        for case in TRAIN_RANKS_MODES:
            out[case] = train_ranks_run(*case, group)
            out[case]["case"] = case
            out[case]["stats"] = dict(group.stats)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        cfg = train.resolve_config(TRAIN_RANKS_ARCH)
        params = lm.init_params(cfg, seed=0, device="cuda")
        b = {k: torch.as_tensor(v).cuda() for k, v in SyntheticLM(DataConfig(
            cfg.vocab_size, TRAIN_RANKS_S, TRAIN_RANKS_B, seed=0)
        ).batch_for_step(0).items()}
        per = TRAIN_RANKS_B // TRAIN_RANKS_PODS
        grads, _ = train.pod_grads(
            params, {k: v[group.lo * per:(group.lo + 1) * per]
                     for k, v in b.items()}, cfg)
        del params
        payload_kernels(f"train_ranks gloo rank 0 pod {group.lo} step-1 "
                        "payload", grads)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def train_rank_report(label, got, one):
    """The measured line of one run beside the one-process run's."""
    def steady(h, key):
        return statistics.mean(x[key] for x in h[1:])

    h, o = got["history"], one["history"]
    extra = ""
    if "gathered_bytes" in h[0]:
        st = got["stats"]
        extra = (f", all-gathered {steady(h, 'gathered_bytes'):.0f} bytes "
                 f"a step in {st['all_gathers'] / TRAIN_RANKS_STEPS:.1f} "
                 f"all-gathers ({steady(h, 'gather_s') * 1e3:.1f} ms of host "
                 "time a step)")
    print(f"train_ranks {label}: {steady(h, 'ms'):.1f} ms a step after "
          f"step 1 (one process {steady(o, 'ms'):.1f}), step ms "
          f"{[round(x['ms'], 1) for x in h]}, peak memory "
          f"{got['peak'] / 2 ** 30:.2f} GiB (one process "
          f"{one['peak'] / 2 ** 30:.2f}){extra}", flush=True)


def train_ranks_exact(label, got, pods):
    """A run's losses are finite and its launches and routes exact."""
    cfg = train.resolve_config(TRAIN_RANKS_ARCH)
    losses = [x["loss"] for x in got["history"]]
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    want, routes = train_ranks_launches(cfg, got, pods)
    launches = {k: v for k, v in got["launches"].items() if v}
    check(launches == {k: v for k, v in want.items() if v},
          f"{label}: launches {launches}, expected {want}")
    check(got["routes"] == routes,
          f"{label}: routes {got['routes']}, expected {routes}")
    return launches


def train_ranks_agree(label, got, one, pods):
    """Losses, grad norms and the final parameters of ``pods`` equal the
    one-process run's bitwise; the launches and routes are exact."""
    launches = train_ranks_exact(label, got, len(pods))
    for key in ("loss", "grad_norm", "aux", "lr"):
        a = [x[key] for x in got["history"]]
        b = [x[key] for x in one["history"]]
        check(a == b, f"{label}: {key} {a}, one process {b}")
    losses = [x["loss"] for x in got["history"]]
    differ = sorted({k for (k, p), v in got["params"].items()
                     if v != one["params"][(k, p)]})
    check(not differ and len(got["params"]) == got["leaves"] * len(pods),
          f"{label}: final parameters differ from one process in {differ}")
    print(f"train_ranks {label}: {TRAIN_RANKS_STEPS} steps == one process "
          f"(losses {[round(x, 6) for x in losses]}, grad norms, final "
          f"parameters of pods {list(pods)} bitwise); launches {launches}",
          flush=True)


@phase("train_ranks")
def train_ranks():
    """Training's pod axis over torch.distributed ranks on the one card:
    qwen3-0.6b uncut, bf16 compute and float32 masters, batch 4 x 2048 at
    n_pods = 2, ``TRAIN_RANKS_STEPS`` steps of mode 0, mode 3 int8 and
    mode 3 top-k through ``train.run_training``: (a) one process holding
    both pods; (b) 2 gloo ranks sharing the card, one pod each (spawned
    here; the payloads staged through pinned host memory); (c) 1 NCCL
    rank holding both pods, in this process.  Each run's losses, grad
    norms and final parameters equal (a)'s bitwise, its launches and
    routes are exact, and its ms a step, all-gathered bytes a step, the
    all-gathers' host time and peak memory are printed beside (a)'s.  Rank
    0 also holds the compression kernels to their plain versions on its
    pod's step-1 payload.  Returns the launches of (a)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    one = {}
    for case in TRAIN_RANKS_MODES:
        one[case] = train_ranks_run(*case)
        one[case]["case"] = case
        label = f"mode {case[0]} {case[1] or 'plain'} one process"
        launches = train_ranks_exact(label, one[case], TRAIN_RANKS_PODS)
        print(f"train_ranks {label}: losses "
              f"{[round(x['loss'], 6) for x in one[case]['history']]}, "
              f"step ms {[round(x['ms'], 1) for x in one[case]['history']]}"
              f", peak memory {one[case]['peak'] / 2 ** 30:.2f} GiB; "
              f"launches {launches}", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(train_rank_main,
                           args=(TRAIN_RANKS_PODS,
                                 os.path.join(tmp, "store"), tmp),
                           nprocs=TRAIN_RANKS_PODS, join=True,
                           start_method="spawn")
        spawned = time.perf_counter() - t0
        got = []
        for r in range(TRAIN_RANKS_PODS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
    for case in TRAIN_RANKS_MODES:
        label = f"mode {case[0]} {case[1] or 'plain'}"
        for r, out in enumerate(got):
            train_ranks_agree(f"{label} gloo rank {r}", out[case], one[case],
                              [r])
            train_rank_report(f"{label} gloo rank {r} of 2", out[case],
                              one[case])
    print(f"train_ranks: 2 gloo ranks spawned, ran and joined in "
          f"{spawned:.1f}s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl",
                                init_method="file://" + os.path.join(
                                    tmp, "store"), rank=0, world_size=1)
        try:
            group = mesh.make_shard_mesh(TRAIN_RANKS_PODS, "nccl")
            for case in TRAIN_RANKS_MODES:
                label = f"mode {case[0]} {case[1] or 'plain'}"
                out = train_ranks_run(*case, group)
                out["case"], out["stats"] = case, dict(group.stats)
                train_ranks_agree(f"{label} 1 nccl rank", out, one[case],
                                  range(TRAIN_RANKS_PODS))
                train_rank_report(f"{label} 1 nccl rank", out, one[case])
        finally:
            dist.destroy_process_group()
    launched = {}
    for case in TRAIN_RANKS_MODES:
        for k, v in one[case]["launches"].items():
            launched[k] = launched.get(k, 0) + v
    return launched


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi, name, hbm = card()
    build()
    records = kernels(hbm)
    oracle()
    card_vs_cpu()
    launched, full_sigs = full_size()
    launched.update(lm_card_vs_cpu())
    launched.update(lm_full_size())
    train_card_vs_cpu()
    launched.update(train_full_size())
    launched.update(jamba_full_size())
    launched.update(xlstm_full_size())
    moe_full_size()
    modality_full_size()
    launched.update(ssm_train_card_vs_cpu())
    launched.update(jamba_train_full_size())
    launched.update(xlstm_train_full_size())
    sharded_launched = sharded(full_sigs["graphcolor torus-4096 window"])
    service_launched = service()
    spmd_launched = spmd()
    replicates_launched = replicates(hbm)
    ranks()
    train_ranks_launched = train_ranks()
    kernels_line = []
    for entry, kname, replaces in ENTRIES:
        rec = records[entry]
        kernels_line.append(dict(
            name=entry, route="cuda",
            source=f"src/repro_torch/kernels/{K.SOURCES[kname]}",
            replaces=replaces, launches=launched[entry],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            ms_by=rec["ms_by"], plain_ms_by=rec["plain_ms_by"],
            library_ms_by=rec["library_ms_by"],
            **{k: rec[k] for k in ("simt_ms", "serving_call_ms",
                                   "saved_states_call_ms",
                                   "without_saved_ms") if k in rec},
            **({"sharded_launches": sharded_launched[entry]}
               if entry in sharded_launched else {}),
            **({"service_launches": service_launched[entry]}
               if service_launched.get(entry) else {}),
            **({"spmd_launches": spmd_launched[entry]}
               if spmd_launched.get(entry) else {}),
            **({"replicates_launches": replicates_launched[entry]}
               if replicates_launched.get(entry) else {}),
            **({"train_ranks_launches": train_ranks_launched[entry]}
               if train_ranks_launched.get(entry) else {})))
    print("phases: " + ", ".join(f"{p} {t:.1f}s" for p, t in PHASES))
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
