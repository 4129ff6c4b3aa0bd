"""Outer optimizer for modes 1/2 (periodic cross-pod parameter sync).  The
counterpart of src/repro/optim/outer.py.

Local-SGD / DiLoCo-style: pods run inner AdamW steps independently; every K
steps the pod-mean parameter delta is applied to a shared anchor via
Nesterov outer momentum.  Every operation is elementwise, so the functions
take one pod's leaves or the pod-stacked ones alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    sync_period: int = 16        # K inner steps per outer sync
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    nesterov: bool = True


def init_outer_state(params: Tree) -> Dict[str, Tree]:
    return {"anchor": {k: p.float().clone() for k, p in params.items()},
            "momentum": {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}}


def outer_step(params: Tree, outer_state: Dict[str, Tree], mean_delta: Tree,
               cfg: OuterConfig):
    """Apply one outer update from the pod-mean delta (anchor - params).
    Returns (new_params, new_outer_state): params reset to the new
    anchor."""
    mu = cfg.outer_momentum
    mom = {k: mu * m + mean_delta[k]
           for k, m in outer_state["momentum"].items()}
    upd = ({k: mu * m + mean_delta[k] for k, m in mom.items()}
           if cfg.nesterov else mom)
    anchor = {k: a - cfg.outer_lr * upd[k]
              for k, a in outer_state["anchor"].items()}
    new_params = {k: anchor[k].to(p.dtype) for k, p in params.items()}
    return new_params, {"anchor": anchor, "momentum": mom}


def maybe_outer_step(params: Tree, outer_state: Dict[str, Tree], do_sync,
                     pod_mean_fn, cfg: OuterConfig):
    """The conditional outer sync of the reference: the delta ``anchor -
    params`` averaged over the pods by ``pod_mean_fn`` (a
    ``collectives.pod_mean`` bound to the pod dim), one ``outer_step``,
    and ``where(do_sync, synced, old)`` for every leaf: the update is
    always computed and selected only on a sync step.  ``do_sync`` is a
    bool or a bool tensor.  Returns (params, outer_state), new trees."""
    delta = {k: a - params[k].float()
             for k, a in outer_state["anchor"].items()}
    synced_p, synced_o = outer_step(params, outer_state, pod_mean_fn(delta),
                                    cfg)

    def sel(new: Tree, old: Tree) -> Tree:
        return {k: torch.where(torch.as_tensor(do_sync, device=o.device),
                               new[k], o) for k, o in old.items()}

    return sel(synced_p, params), {
        "anchor": sel(synced_o["anchor"], outer_state["anchor"]),
        "momentum": sel(synced_o["momentum"], outer_state["momentum"])}
