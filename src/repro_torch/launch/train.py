"""Training driver: the paper's asynchronicity modes on the pod axis.

The counterpart of src/repro/launch/train.py (``TrainSpec``,
``init_train_state``, ``make_train_step``, ``run_training``) and of
examples/train_lm.py (``main``).  The train state is POD-STACKED as the
reference's is: every leaf but the step counter has a leading ``n_pods``
dim, and each parameter tree is a {path: tensor} dict in the reference's
leaf layout (``stack/0/mixer/wq``: the layer parameters stacked over
layers), so checkpoints and ``interop`` carry it across unchanged.  Pods
run one after another on one device, each on its slice of the batch.

The pod axis can be split over ``torch.distributed`` ranks, as the
reference shards it over the "pod" mesh axis: with ``group`` (a
``launch.mesh.RankGroup`` from ``mesh.make_shard_mesh``) each rank holds
``group.per`` pods, from pod ``group.lo``, computes their gradients on
their slice of the batch, and every cross-pod reduction goes through
``core/collectives.py`` with the group (the ranks all-gather the pods and
reduce them in the one-process order), so P ranks give bitwise what one
process gives at the same ``n_pods``.  Checkpoints keep the one-process
layout: rank 0 gathers the state one leaf at a time and writes it, and a
restore gives each rank its pods, so a run restarts on any rank count
that divides ``n_pods``.

  mode 0 — per-step gradient mean over the pods: params stay identical.
  mode 1/2 — no per-step cross-pod traffic; every K steps the outer
           optimizer syncs params (local SGD / rolling vs fixed barrier).
  mode 3 — staleness-1 delayed cross-pod gradient sum, optionally
           compressed (int8 / top-k with error feedback): the sum feeds
           only the next step's update.
  mode 4 — fully independent pods.

It trains every arch of the registry: the dense archs, the MoE archs
(``deepseek-moe-16b``, ``dbrx-132b``; the router's aux loss joins the
loss), the audio and vision archs (``musicgen-large``,
``llava-next-mistral-7b``; each step's batch carries the stub frontend
input), the hybrid ``jamba-v0.1-52b`` (Mamba, attention and MoE blocks)
and ``xlstm-125m`` (mLSTM, sLSTM and ``ffn43`` blocks), each also as
``NAME-smoke``, its reduced config.  A ``Pipeline``
thread makes each step's batch and moves it to the device one step ahead.

The step updates the state IN PLACE (the reference returns a new one):
at qwen2-1.5b's width the float32 state is 31 GB, and a second copy
would not fit beside the activations.  On the card attention runs
through the hand-written CUDA flash-attention kernel (forward, and its
recompute under ``cfg.remat``), the Mamba scan and the mLSTM mix through
their kernels forward and backward, and the compressors through the int8
quantize / dequantize and top-k kernels; on the CPU through their plain
torch versions.

Run::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-1.5b-smoke --steps 30 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-1.5b-smoke --mode 3 --n-pods 2 --compressor topk
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch deepseek-moe-16b-smoke --steps 10 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch musicgen-large-smoke --steps 10 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch jamba-v0.1-52b-smoke --steps 10 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch xlstm-125m-smoke --steps 10 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --batch 4 --seq 2048 --steps 6 --mode 3 --compressor int8   # card
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --device cpu --arch qwen3-0.6b-smoke \\
        --n-pods 2 --mode 3 --compressor int8 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import os
from typing import Dict, Optional

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import reduce_for_smoke
from repro_torch.core import collectives
from repro_torch.core.modes import AsyncMode
from repro_torch.data.pipeline import Pipeline
from repro_torch.data.synthetic import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.models import lm
from repro_torch.models.partitioning import laid_like
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import outer as outer_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import Int8Compressor, TopKCompressor
from repro_torch.optim.outer import OuterConfig

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    mode: AsyncMode = AsyncMode.BARRIER_EVERY_STEP
    adamw: AdamWConfig = AdamWConfig()
    outer: OuterConfig = OuterConfig()
    compressor: Optional[str] = None     # None | "int8" | "topk"
    compress_ratio: float = 0.01         # topk ratio
    quant_block: int = 1024


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def _pod_stack(tree, n_pods: int):
    if isinstance(tree, dict):
        return {k: _pod_stack(v, n_pods) for k, v in tree.items()}
    if n_pods == 1:
        return tree.unsqueeze(0)
    return tree.unsqueeze(0).repeat(n_pods, *([1] * tree.ndim))


def local_pods(n_pods: int, group: Optional[mesh.RankGroup]) -> int:
    """The pods this process holds: all ``n_pods``, or the group's
    ``per``; a group laid over another pod count raises."""
    if group is None:
        return n_pods
    if group.blocks != n_pods:
        raise ValueError(f"the rank group splits {group.blocks} pods over "
                         f"{group.size} ranks, but n_pods is {n_pods}")
    return group.per


def init_train_state(cfg, spec: TrainSpec, n_pods: int = 1, *,
                     seed: int = 0, device="cuda",
                     group: Optional[mesh.RankGroup] = None) -> Dict:
    """{"params", "opt": {"m", "v", "step"}, "step"} plus "others" and
    "residuals" (mode 3, the latter with a compressor) or "outer" (modes
    1/2), every leaf but "step" stacked over ``n_pods`` (over ``group``,
    this rank's ``group.per`` pods); float32 masters from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    n_pods = local_pods(n_pods, group)
    params = lm.init_params(cfg, seed=seed, device=device)
    state = {"params": params, "opt": adamw_mod.init_opt_state(params)}
    if spec.mode == AsyncMode.BEST_EFFORT:
        state["others"] = {k: torch.zeros_like(v) for k, v in params.items()}
        if spec.compressor is not None:
            state["residuals"] = {k: torch.zeros_like(v)
                                  for k, v in params.items()}
    if spec.mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
        state["outer"] = outer_mod.init_outer_state(params)
    state = _pod_stack(state, n_pods)
    state["step"] = torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)
    return state


def abstract_train_state(cfg, spec: TrainSpec, n_pods: int = 1) -> Dict:
    """``init_train_state``'s leaves as meta tensors, their shapes and
    dtypes, built under ``FakeTensorMode``: nothing is allocated (the
    reference's ``abstract_train_state``, ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    with FakeTensorMode():
        fake = init_train_state(cfg, spec, n_pods, device="cpu")
    return meta(fake)


def state_specs(cfg, spec: TrainSpec, rules) -> Dict:
    """The specs of the pod-stacked train state under ``rules`` (pod-
    stacked ones, ``rules_for(..., pod_stacked=True)``), as the
    reference's dry run lays it: every leaf of the parameters, moments,
    ``others``, ``residuals`` and ``outer`` by ``param_specs`` behind a
    "pod" entry, the moments' step counter ("pod",), the step counter
    replicated.  On a mesh without a "pod" axis the pod entries are None
    (the reference's ``strip_pod``)."""
    from repro_torch.launch.sharding import (param_specs, strip_axis,
                                             with_pod_dim)
    from repro_torch.models.partitioning import P
    pspecs = with_pod_dim(param_specs(lm.abstract_params(cfg), rules))
    multi = "pod" in rules.mesh.axis_names
    specs = {"params": pspecs,
             "opt": {"m": pspecs, "v": pspecs,
                     "step": P("pod" if multi else None)},
             "step": P()}
    if spec.mode == AsyncMode.BEST_EFFORT:
        specs["others"] = pspecs
        if spec.compressor:
            specs["residuals"] = pspecs
    if spec.mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
        specs["outer"] = {"anchor": pspecs, "momentum": pspecs}
    return specs if multi else strip_axis(specs)


def state_mesh(dmesh):
    """The mesh the train state's DTensors live on: ``dmesh``'s ("data",
    "model") axes where it has a "pod" axis (the pods are split over the
    pod group instead, ``mesh.pod_group``), else ``dmesh``."""
    if "pod" in dmesh.mesh_dim_names:
        return dmesh["data", "model"]
    return dmesh


def shard_train_state(state, cfg, spec: TrainSpec, rules, dmesh) -> Dict:
    """``state`` (this rank's pods of a pod-stacked train state, each
    leaf whole: every rank made it from one seed) as DTensors laid out by
    ``state_specs`` on ``state_mesh(dmesh)``: each rank keeps its block."""
    from repro_torch.launch.sharding import (place, shardings_from_specs,
                                             strip_axis)
    specs = strip_axis(state_specs(cfg, spec, rules))
    return place(state, shardings_from_specs(specs, state_mesh(dmesh)))


def shard_batch(batch, cfg, rules, dmesh, n_pods: int) -> Dict:
    """This rank's pods of a step's batch as DTensors by
    ``make_batch_specs`` on ``state_mesh(dmesh)``."""
    from repro_torch.launch.sharding import (place, shardings_from_specs,
                                             strip_axis)
    specs = strip_axis(make_batch_specs(cfg, rules, n_pods))
    return place(batch, shardings_from_specs(
        {k: specs[k] for k in batch}, state_mesh(dmesh)))


def make_batch_specs(cfg, rules, n_pods: int) -> Dict:
    """Specs of the pod-stacked batch: pods over "pod" (where the mesh has
    it), each pod's rows over "data"."""
    from repro_torch.models.modality import frontend_input_name
    from repro_torch.models.partitioning import P
    pod = "pod" if "pod" in rules.mesh.axis_names else None
    specs = {"tokens": P(pod, "data", None), "labels": P(pod, "data", None)}
    if cfg.frontend:
        specs[frontend_input_name(cfg)] = P(pod, "data", None, None)
    return specs


# ---------------------------------------------------------------------------
# Compression along the pod-stacked dim
# ---------------------------------------------------------------------------
def make_compressor(spec: TrainSpec):
    return (Int8Compressor(block=spec.quant_block) if spec.compressor == "int8"
            else TopKCompressor(ratio=spec.compress_ratio))


def _compressed_total(g: torch.Tensor, res: torch.Tensor, comp,
                      group: Optional[mesh.RankGroup] = None
                      ) -> torch.Tensor:
    """One leaf's cross-pod sum with a lossy payload, through
    ``collectives.cross_pod_sum``: each pod encodes its gradient plus its
    residual (its new residual is written into ``res`` in place), and the
    pods' payloads (over ``group``, all-gathered from every rank) are
    decoded and summed, pod by pod.  Returns the total, (1, ...)."""
    total, _ = collectives.cross_pod_sum(g, 0, comp, res, group)
    return total[:1]


def _readable(t: torch.Tensor) -> bool:
    """Whether ``t``'s value can be read: not a meta tensor (nor a DTensor
    of one), the dry run's."""
    from repro_torch.models.partitioning import is_dtensor
    return (t.to_local() if is_dtensor(t) else t).device.type != "meta"


def _pod_mean(x: torch.Tensor, group: Optional[mesh.RankGroup]
              ) -> torch.Tensor:
    """The mean over every pod of ``x`` (pods along dim 0), (1, ...)."""
    return collectives.pod_mean(x, 0, group)[:1]


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def pod_grads(params: Tree, batch: Tree, cfg, param_specs=None):
    """Gradients of ``lm.loss_fn`` at one pod's leaves (float32, each the
    leaf's shape) and its metrics {"ce", "aux"}; microbatched over
    ``cfg.grad_accum`` as the reference's scan is.  ``param_specs`` pins
    the compute casts (``lm.cast_leaves``)."""
    def grads_of(mb):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, metrics = lm.loss_fn(leaves, mb, cfg, param_specs)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return ({k: laid_like(g, leaves[k]) for k, g in zip(leaves, grads)},
                {k: v.detach() for k, v in metrics.items()})

    A = cfg.grad_accum
    if A <= 1:
        return grads_of(batch)
    acc_g = {k: torch.zeros_like(v, dtype=torch.float32)
             for k, v in params.items()}
    acc_m = {"ce": 0.0, "aux": 0.0}
    for a in range(A):
        mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[a]
              for k, v in batch.items()}
        g, m = grads_of(mb)
        for k in acc_g:
            acc_g[k] += g[k]
        acc_m = {k: acc_m[k] + m[k] for k in acc_m}
    inv = 1.0 / A
    return ({k: v * inv for k, v in acc_g.items()},
            {k: v * inv for k, v in acc_m.items()})


def make_update(spec: TrainSpec, n_pods: int = 1,
                group: Optional[mesh.RankGroup] = None):
    """The step after the gradients: the cross-pod exchange of
    ``spec.mode``, AdamW per pod, and the outer sync of modes 1/2.
    ``update(state, grads, metrics)``: grads {path: (pods, ...)}, metrics
    {"ce", "aux"}: (pods,), where pods is ``n_pods`` or, over ``group``,
    this rank's.  Every reduction over the pods goes through
    ``core/collectives.py`` with ``group``, so the metrics are the means
    over all ``n_pods`` on every rank.  Updates ``state`` in place and
    returns (state, {"loss", "aux", "grad_norm", "lr"})."""
    mode = spec.mode
    pods = local_pods(n_pods, group)
    comp = (make_compressor(spec) if mode == AsyncMode.BEST_EFFORT
            and spec.compressor is not None else None)

    def update(state, grads: Tree, metrics: Tree):
        params = state["params"]
        # ---- cross-pod exchange (along the stacked pod dim) ------------
        if mode == AsyncMode.BARRIER_EVERY_STEP:
            eff = {k: _pod_mean(g, group).expand_as(g)
                   for k, g in grads.items()}
        elif mode == AsyncMode.BEST_EFFORT:
            eff = {}
            for k, g in grads.items():
                total = (collectives.cross_pod_sum(g, 0, group=group)[0][:1]
                         if comp is None else
                         _compressed_total(g, state["residuals"][k], comp,
                                           group))
                others = state["others"][k]
                eff[k] = (g + others) / n_pods
                others.copy_(total - g)
                del total
        else:  # modes 1, 2, 4: pod-local gradients
            eff = grads

        # ---- inner optimizer, pod by pod -------------------------------
        opt = state["opt"]
        norms, lrs = [], []
        for p in range(pods):
            _, _, om = adamw_mod.apply_updates(
                {k: v[p] for k, v in params.items()},
                {k: v[p] for k, v in eff.items()},
                {"m": {k: v[p] for k, v in opt["m"].items()},
                 "v": {k: v[p] for k, v in opt["v"].items()},
                 "step": opt["step"][p]}, spec.adamw)
            norms.append(om["grad_norm"])
            lrs.append(om["lr"])
        del eff

        # ---- outer sync for modes 1/2 ----------------------------------
        if mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER):
            period = spec.outer.sync_period
            outer = state["outer"]
            if not _readable(state["step"]):
                # the dry run's meta counter: the reference's in-graph
                # select, every leaf computed and chosen by the step
                new_p, new_o = outer_mod.maybe_outer_step(
                    params, outer, state["step"] % period == period - 1,
                    lambda t: {k: _pod_mean(v, group).expand_as(v)
                               for k, v in t.items()}, spec.outer)
                for k in params:
                    params[k].copy_(new_p[k])
                    outer["anchor"][k].copy_(new_o["anchor"][k])
                    outer["momentum"][k].copy_(new_o["momentum"][k])
            elif int(state["step"]) % period == period - 1:
                mean_delta = {
                    k: _pod_mean(a - params[k].float(), group).expand_as(a)
                    for k, a in outer["anchor"].items()}
                new_p, new_o = outer_mod.outer_step(params, outer,
                                                    mean_delta, spec.outer)
                for k in params:
                    params[k].copy_(new_p[k])
                    outer["anchor"][k].copy_(new_o["anchor"][k])
                    outer["momentum"][k].copy_(new_o["momentum"][k])

        state["step"].add_(1)
        return state, {"loss": _pod_mean(metrics["ce"], group)[0],
                       "aux": _pod_mean(metrics["aux"], group)[0],
                       "grad_norm": _pod_mean(torch.stack(norms), group)[0],
                       "lr": lrs[0]}

    return update


def make_train_step(cfg, spec: TrainSpec, n_pods: int = 1,
                    group: Optional[mesh.RankGroup] = None,
                    param_specs=None):
    """``train_step(state, batch)``: batch {"tokens", "labels"}
    (pods, B / n_pods, S): every pod, or over ``group`` this rank's pods
    (pods ``[group.lo, group.lo + group.per)`` of the step's batch).  Each
    pod's gradients at its own parameters on its slice of the batch, then
    ``make_update``'s step; the state is updated in place.  Returns
    (state, metrics).

    The same step runs over a device mesh: with every leaf a DTensor on
    the ("data", "model") axes (``launch/sharding.py``), the pods over
    ``group`` (``mesh.pod_group``), under the rules
    (``partitioning.use_rules``) and ``implicit_replication``, the
    model's constraint sites redistribute the activations and the kernels
    run on every device's block; ``param_specs`` ({path: P}, the
    unstacked leaves') pins the compute casts, as in the reference."""
    update = make_update(spec, n_pods, group)
    pods = local_pods(n_pods, group)

    def train_step(state, batch):
        got = next(iter(batch.values())).shape[0]
        if got != pods:
            raise ValueError(f"the batch holds {got} pods, this process "
                             f"{pods}")
        params = state["params"]
        grads: Dict[str, list] = {k: [] for k in params}
        ces, auxes = [], []
        for p in range(pods):
            g, m = pod_grads({k: v[p] for k, v in params.items()},
                             {k: v[p] for k, v in batch.items()}, cfg,
                             param_specs)
            for k in params:
                grads[k].append(g.pop(k))
            ces.append(m["ce"])
            auxes.append(m["aux"])
        stacked = {k: (v[0].unsqueeze(0) if pods == 1 else torch.stack(v))
                   for k, v in grads.items()}
        del grads
        return update(state, stacked, {"ce": torch.stack(ces),
                                       "aux": torch.stack(auxes)})

    return train_step


# ---------------------------------------------------------------------------
# Training driver (checkpoint/restart)
# ---------------------------------------------------------------------------
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gather_state(state, group: mesh.RankGroup, path: str = ""):
    """The one-process state of ``n_pods`` from every rank's pods, in host
    memory on rank 0 (None on the others).  The ranks all-gather one leaf
    at a time, in the sorted path order (the same on every rank), and
    rank 0 copies each to the host before the next, so no rank holds the
    whole pod stack on its device; the step counter is whole on every
    rank."""
    if isinstance(state, dict):
        out = {k: gather_state(v, group, f"{path}{k}/")
               for k, v in sorted(state.items())}
        return out if group.rank == 0 else None
    whole = state if path == "step/" else group.all_gather(state, 0)
    return whole.cpu() if group.rank == 0 else None


def save_checkpoint(ckpt_dir: str, state, step: int,
                    group: Optional[mesh.RankGroup] = None) -> None:
    """Write ``state`` at ``step`` in the one-process layout and keep the
    latest two checkpoints: over ``group`` every rank takes part in the
    gather and rank 0 writes the same files one process writes."""
    if group is not None:
        state = gather_state(state, group)
        if group.rank != 0:
            return
    ckpt_mod.save(ckpt_dir, state, step)
    ckpt_mod.prune(ckpt_dir, keep=2)


def restore_checkpoint(ckpt_dir: str, step: int, like,
                       group: Optional[mesh.RankGroup] = None):
    """Restore a one-process checkpoint into ``like``: over ``group`` this
    rank's pods of every stacked leaf.  A checkpoint of another pod count
    raises."""
    if group is None:
        return ckpt_mod.restore(ckpt_dir, step, like)

    def take(path, arr):
        if path == "step":
            return arr
        if arr.shape[0] != group.blocks:
            raise ValueError(f"{path}: the checkpoint holds {arr.shape[0]} "
                             f"pods, the run {group.blocks}")
        return arr.narrow(0, group.lo, group.per).clone()

    return ckpt_mod.restore(ckpt_dir, step, like, take=take)


def run_training(cfg, spec: TrainSpec, data_cfg: DataConfig, *, steps: int,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 n_pods: int = 1, log_every: int = 10, log=print,
                 device="cuda", seed: int = 0,
                 group: Optional[mesh.RankGroup] = None):
    """Train for ``steps`` steps with checkpoint/restart.

    Restores from the latest checkpoint in ``ckpt_dir`` if one exists; the
    per-step data stream (``SyntheticLM.batch_for_step``, and the frontend
    input where ``cfg`` has one), prefetched onto the device by a
    ``Pipeline`` thread, resumes exactly.  Returns (state, history): one
    entry per logged step with the metrics and ``ms``, the wall time per
    step since the previous entry (the host clock around work that ends in
    a synchronize).

    With ``group`` (``mesh.make_shard_mesh(n_pods, ...)``) this rank runs
    pods ``[group.lo, group.lo + group.per)`` of each step's batch on
    ``group.device`` (``device`` is not read), only rank 0 logs, and each
    history entry also has ``gathered_bytes`` and ``gather_s``: the bytes
    this rank sent in all-gathers and their host seconds, a step."""
    dev = resolve_device(device) if group is None else group.device
    say = log if group is None or group.rank == 0 else (lambda _: None)
    state = init_train_state(cfg, spec, n_pods, seed=seed, device=dev,
                             group=group)
    start = 0
    if ckpt_dir is not None:
        last = ckpt_mod.latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state, group)
            start = last
            say(f"[train] restored checkpoint at step {last}")

    step_fn = make_train_step(cfg, spec, n_pods, group)
    lo, per = (0, n_pods) if group is None else (group.lo, group.per)
    history = []

    def pod_batch(batch):
        return {key: v.reshape(n_pods, v.shape[0] // n_pods,
                               *v.shape[1:])[lo:lo + per]
                for key, v in batch.items()}

    def gathered():
        return ((0, 0.0) if group is None else
                (group.stats["all_gather_bytes"],
                 group.stats["all_gather_s"]))

    pipeline = Pipeline(data_cfg, cfg, start_step=start, device=dev)
    try:
        _sync(dev)
        t_prev, k_prev = time.perf_counter(), start
        sent, secs = 0, 0.0
        for k in range(start, steps):
            b0, s0 = gathered()
            state, metrics = step_fn(state, pod_batch(next(pipeline)[1]))
            b1, s1 = gathered()
            sent, secs = sent + b1 - b0, secs + s1 - s0
            if (k + 1) % log_every == 0 or k == steps - 1:
                m = {key: float(v) for key, v in metrics.items()}
                _sync(dev)
                now = time.perf_counter()
                m["ms"] = (now - t_prev) * 1e3 / (k + 1 - k_prev)
                if group is not None:
                    m["gathered_bytes"] = sent / (k + 1 - k_prev)
                    m["gather_s"] = secs / (k + 1 - k_prev)
                t_prev, k_prev, sent, secs = now, k + 1, 0, 0.0
                history.append({"step": k + 1, **m})
                say(f"[train] step {k + 1}: loss={m['loss']:.4f} "
                    f"aux={m['aux']:.4g} grad_norm={m['grad_norm']:.3f} "
                    f"lr={m['lr']:.2e} {m['ms']:.1f} ms/step")
            if ckpt_dir is not None and (k + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, state, k + 1, group)
    finally:
        pipeline.close()
    return state, history


# ---------------------------------------------------------------------------
# CLI (examples/train_lm.py's driver)
# ---------------------------------------------------------------------------
#: examples/train_lm.py's presets: "10m" (its defaults, 8 layers of width
#: 256) and "100m"
PRESETS = {
    "10m": ModelConfig(name="lm-10m", family="dense", num_layers=8,
                       d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                       vocab_size=4096, tie_embeddings=True),
    "100m": ModelConfig(name="lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=12,
                        d_ff=2048, vocab_size=32768, tie_embeddings=True),
}


def resolve_config(arch: str) -> ModelConfig:
    """A preset (``10m``, ``100m``), a registered arch, or ``NAME-smoke``
    for NAME's reduced config."""
    if arch in PRESETS:
        return PRESETS[arch]
    if arch.endswith("-smoke"):
        return reduce_for_smoke(get_config(arch[:-len("-smoke")]))
    return get_config(arch)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="10m",
                    help="10m (default) or 100m (examples/train_lm.py's "
                         "presets), a registered arch (dense, MoE, audio, "
                         "vision, jamba-v0.1-52b, xlstm-125m), or "
                         "NAME-smoke")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--mode", type=int, default=0,
                    help="asynchronicity mode (cross-pod; needs n-pods > 1)")
    ap.add_argument("--n-pods", type=int, default=1)
    ap.add_argument("--compressor", default="none",
                    choices=["none", "int8", "topk"],
                    help="mode 3's lossy cross-pod payload")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint and restart directory (default: "
                         "none); the one-process layout whatever the ranks")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (default 50)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the data stream")
    ap.add_argument("--dist-backend", default=None, choices=mesh.BACKENDS,
                    help="under torch.distributed.run: split the --n-pods "
                         "over the ranks; nccl puts one rank on each card, "
                         "gloo runs ranks on the CPU or sharing a card")
    ap.add_argument("--dist-init", default=None,
                    help="the process group's init method (default env://, "
                         "the store torch.distributed.run starts; "
                         "file:///path needs no TCP port)")
    return ap


def _init_ranks(args, parser) -> Optional[mesh.RankGroup]:
    """Join the ranks ``torch.distributed.run`` started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` in the environment) and return the pod
    group the ``--n-pods`` are split over; without those variables the run
    is one process (None).  Every refusal is a parser error, made before
    joining where the flags alone decide it."""
    if "WORLD_SIZE" not in os.environ:
        if args.dist_backend or args.dist_init:
            parser.error("--dist-backend / --dist-init split the pods over "
                         "ranks; launch through python -m "
                         "torch.distributed.run (it sets RANK, WORLD_SIZE "
                         "and LOCAL_RANK)")
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.dist_backend is None:
        parser.error(f"rank {rank} of {world}: pass --dist-backend nccl (one "
                     "card a rank) or gloo (the CPU, or ranks sharing a "
                     "card)")
    if args.n_pods % world:
        parser.error(f"--n-pods {args.n_pods} must split over the {world} "
                     "ranks")
    import torch.distributed as dist
    if args.dist_backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards or args.device != "cuda":
            parser.error(f"--dist-backend nccl puts one rank on each card: "
                         f"{world} ranks, {cards} visible card(s), device "
                         f"{args.device}; ranks sharing a card or the CPU "
                         "need --dist-backend gloo")
        torch.cuda.set_device(local)
    dist.init_process_group(args.dist_backend,
                            init_method=args.dist_init or "env://",
                            rank=rank, world_size=world)
    try:
        return mesh.make_shard_mesh(args.n_pods, args.dist_backend,
                                  device=args.device, local_rank=local)
    except (ValueError, RuntimeError) as e:
        dist.destroy_process_group()
        parser.error(str(e))


def main(argv=None):
    """Train from the flags; print each logged step and a summary (over
    ranks, rank 0 prints).  Returns (state, history): over ranks, this
    rank's pods of the state."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = resolve_config(args.arch)
    if args.batch % args.n_pods:
        raise ValueError(f"--batch {args.batch} must split over --n-pods "
                         f"{args.n_pods}")
    group = _init_ranks(args, parser)
    try:
        return _train(args, cfg, dev, group)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, dev, group):
    lead = group is None or group.rank == 0
    say = print if lead else (lambda *_: None)
    if group is not None:
        dev = group.device
    spec = TrainSpec(mode=AsyncMode(args.mode),
                     adamw=AdamWConfig(lr=args.lr, warmup_steps=20,
                                       total_steps=args.steps),
                     compressor=(None if args.compressor == "none"
                                 else args.compressor))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"[train] {cfg.name} ({cfg.dtype} compute, float32 masters) on "
        f"{name}: batch {args.batch} x seq {args.seq}, mode "
        f"{int(spec.mode)}, {args.n_pods} pod(s), compressor "
        f"{args.compressor}")
    state, history = run_training(cfg, spec, data_cfg, steps=args.steps,
                                  ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every,
                                  n_pods=args.n_pods,
                                  log_every=args.log_every,
                                  device=dev, seed=args.seed, group=group)
    first, last = history[0]["loss"], history[-1]["loss"]
    steady = history[1:] or history
    ms = sum(h["ms"] for h in steady) / len(steady)
    say(f"[train] done: loss {first:.3f} -> {last:.3f} "
        f"({'improved' if last < first else 'NO IMPROVEMENT'}); "
        f"{ms:.1f} ms/step, {args.batch * args.seq * 1e3 / ms:.0f} "
        f"tokens/s after the first logged step")
    if group is not None:
        sent = sum(h["gathered_bytes"] for h in steady) / len(steady)
        secs = sum(h["gather_s"] for h in steady) / len(steady)
        by_rank = group.all_gather(torch.tensor(
            [ms], dtype=torch.float64, device=dev), 0).tolist()
        say(f"[train] {group.size} {group.backend} ranks, {group.per} "
            f"pod(s) a rank: ms/step by rank "
            f"{[round(x, 1) for x in by_rank]}; each rank all-gathered "
            f"{sent:.0f} bytes a step ({secs * 1e3:.1f} ms of host time)")
    return state, history


if __name__ == "__main__":
    main()
