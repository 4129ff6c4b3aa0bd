"""Best-effort collectives for the cross-pod gradient/parameter path.

The torch counterpart of the reference's ``core/collectives.py``.  The
reference runs these inside ``shard_map`` bodies over the "pod" axis; here
the pods are dimension ``dim`` of each leaf (the pod-stacked train state of
``launch/train.py``).  In one process every pod is there, so a psum is a
sum over that dimension and an all-gather is a stack.  With ``group`` (a
``launch.mesh.RankGroup``) the pods are split over ``torch.distributed``
ranks, each leaf holding this rank's pods: the ranks all-gather the pods
and sum or stack them in the one-process order, so P ranks give bitwise
what one process gives (an all-reduce would sum in another order and round
differently for more than two pods).  They implement the
paper's asynchronicity modes on the gradient path (DESIGN.md §2):

  mode 0  — synchronous cross-pod mean every step
  mode 1/2— no per-step cross-pod traffic; periodic parameter sync (outer opt)
  mode 3  — staleness-1 delayed cross-pod sum; optionally lossy-compressed
            (top-k / int8) with error feedback — the "message drop + no
            retry" analogue; the compressors run the hand-written
            ``quantize`` / ``dequantize`` and ``topk_compress`` kernels on
            a CUDA leaf (``optim/compression.py``)
  mode 4  — no cross-pod communication

A tree is a tensor, or a dict (or list or tuple) of trees.  Results
reduced over the pods come back as ``(1, ...)`` tensors expanded over the
pods without a copy, which is what each pod of the reference holds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.modes import AsyncMode
from repro_torch.launch import mesh

POD_AXIS = "pod"


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every pod's block along ``dim``: ``x`` itself in one process."""
    return x if group is None else group.all_gather(x, dim)


def _psum(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum over every pod, expanded over this process's pods.  One
    expression in both layouts: over ranks it reduces the gathered pods
    exactly as one process reduces its own."""
    return _gathered(x, dim, group).sum(dim, keepdim=True).expand_as(x)


def _pods(x: torch.Tensor, dim: int, group=None) -> int:
    """The pods over every rank."""
    return x.shape[dim] * (1 if group is None else group.size)


# ---------------------------------------------------------------------------
# Compressed cross-pod sums
# ---------------------------------------------------------------------------
def cross_pod_sum(tree, dim: int = 0, compressor=None, residuals=None,
                  group: Optional[mesh.RankGroup] = None):
    """Sum a tree across the pods, dimension ``dim`` of every leaf (over
    the ranks of ``group``, where given).

    Without a compressor this is a plain sum.  With one, each pod encodes
    its ``leaf + residual`` (lossy, with error feedback), the pods'
    payloads are stacked (the reference's all-gather; over ranks, each
    rank's stack all-gathered in rank order) and decoded and summed, pod
    by pod.  A residual tree handed over is written in place; without one
    the residuals start at zero and come back as new tensors.  Returns
    (summed tree, new residuals).
    """
    if compressor is None:
        return _map(lambda x: _psum(x, dim, group), tree), residuals
    if residuals is None:
        residuals = _map(torch.zeros_like, tree)

    def leaf_sum(leaf, res):
        carry = leaf + res
        payloads = []
        for p in range(leaf.shape[dim]):
            payload, new_res = compressor.encode(carry.select(dim, p))
            res.select(dim, p).copy_(new_res)
            payloads.append(payload)
        del carry
        gathered = {name: _gathered(torch.stack([pl[name]
                                                 for pl in payloads]),
                                    0, group)
                    for name in payloads[0]}
        shape = leaf.shape[:dim] + leaf.shape[dim + 1:]
        total = compressor.decode_sum(gathered, shape, leaf.dtype)
        return total.unsqueeze(dim).expand_as(leaf)

    return _map(leaf_sum, tree, residuals), residuals


# ---------------------------------------------------------------------------
# Gradient exchange per asynchronicity mode
# ---------------------------------------------------------------------------
def init_exchange_state(grads_like, mode: AsyncMode, compressor=None):
    state = {}
    if mode == AsyncMode.BEST_EFFORT:
        state["others"] = _map(torch.zeros_like, grads_like)
        if compressor is not None:
            state["residuals"] = _map(torch.zeros_like, grads_like)
    return state


def exchange_gradients(grads, state: dict, mode: AsyncMode, dim: int = 0,
                       compressor=None,
                       group: Optional[mesh.RankGroup] = None):
    """grads: the pods' local mean gradients, stacked along ``dim`` (this
    rank's pods, over the ranks of ``group``).  Returns (effective_grads,
    new_state).

    BEST_EFFORT: effective grad at step t combines each pod's fresh
    gradient with the *other* pods' step t-1 gradients (staleness-1).  The
    cross-pod reduction issued here is consumed next step.  The residuals
    of a compressor are updated in place.
    """
    if mode == AsyncMode.BARRIER_EVERY_STEP:
        return _map(lambda g: _psum(g, dim, group) / _pods(g, dim, group),
                    grads), state
    if mode in (AsyncMode.ROLLING_BARRIER, AsyncMode.FIXED_BARRIER,
                AsyncMode.NO_COMM):
        return grads, state  # cross-pod sync handled by the outer optimizer

    assert mode == AsyncMode.BEST_EFFORT
    eff = _map(lambda g, o: (g + o) / _pods(g, dim, group), grads,
               state["others"])
    total, new_res = cross_pod_sum(grads, dim, compressor,
                                   state.get("residuals"), group)
    others_new = _map(lambda t, g: t - g, total, grads)
    new_state = dict(state, others=others_new)
    if compressor is not None:
        new_state["residuals"] = new_res
    return eff, new_state


# ---------------------------------------------------------------------------
# Periodic parameter sync (modes 1/2 outer step)
# ---------------------------------------------------------------------------
def pod_mean(tree, dim: int = 0, group: Optional[mesh.RankGroup] = None):
    """The mean over every pod as the sum divided by the pod count (the
    reference's ``jnp.mean``; torch's CUDA ``mean`` multiplies by the
    reciprocal instead, which rounds otherwise for 3 pods), expanded over
    this process's pods.  ``launch/train.py`` takes every mean over the
    pods from here."""
    return _map(lambda x: _psum(x, dim, group) / _pods(x, dim, group), tree)


def maybe_param_sync(params, do_sync, dim: int = 0,
                     group: Optional[mesh.RankGroup] = None):
    """Average parameters across pods when ``do_sync`` (a bool or a bool
    tensor) is set.  The mean is always computed and ``where`` selects it
    only on sync steps, as the reference does."""
    mean = pod_mean(params, dim, group)
    return _map(lambda m, p: torch.where(torch.as_tensor(
        do_sync, device=p.device), m, p), mean, params)
