"""AdamW on {path: tensor} dicts.  The counterpart of
src/repro/optim/adamw.py.

The reference's functions are pure and the train step vmaps them over the
pod dim; here a caller hands one pod's leaves (views into the pod-stacked
train state) and ``apply_updates`` updates them IN PLACE, so a step needs
no second copy of the parameters or moments.  Float32 throughout, with
the reference's formulas; sums are taken in another order than XLA's, and
``b1 ** step`` and ``cos`` are torch's, so results agree with the
reference to float32 rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params: Tree) -> Dict:
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(params.values())).device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the tree's order (the
    reference's leaf order for the train state's dicts)."""
    total = None
    for leaf in tree.values():
        s = leaf.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params: Tree, grads: Tree, state: Dict,
                  cfg: AdamWConfig):
    """One AdamW step.  Updates ``params`` and ``state`` ({"m", "v",
    "step"}) IN PLACE and returns (params, state, {"grad_norm", "lr"}).
    Decoupled weight decay applies where a leaf has two or more dims: the
    reference's leaves are stacked over layers, so that is every leaf but
    ``final_norm``, norm scales and biases included."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    mhat_c = 1.0 / (1 - torch.pow(torch.tensor(b1, device=sf.device), sf))
    vhat_c = 1.0 / (1 - torch.pow(torch.tensor(b2, device=sf.device), sf))
    lr = schedule(cfg, step)
    for name, p in params.items():
        # the reference's expressions, each rounding in the same place,
        # with in-place operations so a leaf needs few temporaries
        m, v = state["m"][name], state["v"][name]
        g = (grads[name] * clip).to(m.dtype)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        u = (m * mhat_c).div_(torch.sqrt_(v * vhat_c).add_(cfg.eps))
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u.add_(cfg.weight_decay * p.to(u.dtype))
        p.copy_((p.float() - u.mul_(lr)).to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
