"""Carry state across: a vectorized engine's window carry between numpy
and the torch engine, an LM's weights and decode caches between the
reference's pytrees (as numpy arrays) and the port's modules, and a train
state between the reference's pytree and the port's dicts.

The reference engine's carry, after ``jax.device_get``, is a dict of numpy
arrays (the application state nested under ``"app"``); the torch engine's
carry has the same key names as torch tensors.  Converting one into the
other lets both engines continue from the identical mid-run state, the
counterpart of carrying weights across for a model.

Dtypes carry over as they are, with one exception: torch has few uint32
operations, so the port holds every uint32 array of the reference (evo's
``acc``) as int64 in [0, 2**32), and the port's carry holds no other
int64.  ``carry_from_numpy`` widens uint32 to int64 and ``carry_to_numpy``
narrows int64 back to uint32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _from_numpy(v, device) -> torch.Tensor:
    a = np.array(v, copy=True)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.dtype == np.int64:
        if a.size and (a.min() < 0 or a.max() > np.iinfo(np.uint32).max):
            raise ValueError("an int64 carry array must hold uint32 values "
                             "in [0, 2**32)")
        a = a.astype(np.uint32)
    return a


def carry_from_numpy(carry, device) -> Dict:
    """A carry of numpy arrays (nested dicts allowed) as torch tensors on
    ``device``, keeping every key and dtype (bool, int8, int32, float32),
    with uint32 held as int64."""
    return {k: (carry_from_numpy(v, device) if isinstance(v, dict)
                else _from_numpy(v, device))
            for k, v in carry.items()}


def carry_to_numpy(carry) -> Dict:
    """A torch carry as nested dicts of numpy arrays (same key names), with
    int64 returned to the reference's uint32."""
    return {k: (carry_to_numpy(v) if isinstance(v, dict) else _to_numpy(v))
            for k, v in carry.items()}


# ---------------------------------------------------------------------------
# LM weights and caches (the model modules are imported inside the
# functions: they import the engine module, which imports this one)
# ---------------------------------------------------------------------------
def _array(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; bfloat16 (which numpy holds only
    through an extension dtype) goes through an exact float32 copy."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a, copy=True))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_numpy(params_np, cfg, device):
    """The reference's ``lm.init_params`` pytree, as numpy arrays, as the
    port's ``LM`` on ``device``.  The reference stacks each period
    position's layers as ``(P, ...)`` arrays in a tuple over positions;
    layer ``period * len(specs) + position`` of the port's stack gets slice
    ``period`` of position ``position``."""
    from repro_torch.models.lm import LM
    from repro_torch.models.transformer import block_specs

    model = LM(cfg, device=device)
    state = model.state_dict()
    n_pos = len(block_specs(cfg))
    flat = _flatten({k: v for k, v in params_np.items() if k != "stack"})
    for pos, stacked in enumerate(params_np["stack"]):
        for name, arr in _flatten(stacked).items():
            for period in range(arr.shape[0]):
                flat[f"stack.blocks.{period * n_pos + pos}.{name}"] = \
                    arr[period]
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise ValueError(f"params do not match {cfg.name}: missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, t in state.items():
            src = _array(flat[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(src)
    return model


def caches_from_numpy(caches_np, cfg, device) -> List[Dict[str, torch.Tensor]]:
    """The reference's stacked caches (a tuple over period positions of
    dicts of ``(P, ...)`` arrays: {"k", "v"} ``(P, B, S, KH, hd)`` for an
    attention position, {"h", "conv"} for a Mamba one, {"C", "n", "m",
    "conv"} for an mLSTM one, {"c", "n", "h", "m"} for an sLSTM one) as
    the port's
    per-layer list of dicts of tensors on ``device``, each with its
    position's names."""
    from repro_torch.models.transformer import block_specs

    n_pos = len(block_specs(cfg))
    P = cfg.num_layers // n_pos
    return [{name: _array(arr[i // n_pos]).to(device)
             for name, arr in caches_np[i % n_pos].items()}
            for i in range(P * n_pos)]


def caches_to_numpy(caches, cfg) -> Tuple[Dict[str, np.ndarray], ...]:
    """The port's per-layer caches stacked as the reference's tuple over
    period positions of dicts of ``(P, ...)`` arrays, each position with
    its own names; bfloat16 comes back as float32 (exact)."""
    from repro_torch.models.transformer import block_specs

    n_pos = len(block_specs(cfg))

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tuple({name: np.stack([arr(caches[i][name])
                                  for i in range(pos, len(caches), n_pos)])
                  for name in caches[pos]}
                 for pos in range(n_pos))


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------
#: the sub-trees of the reference's train state that hold one leaf per
#: parameter; the port keeps each as a flat {path: tensor} dict
PARAM_TREES = ("params", "opt/m", "opt/v", "others", "residuals",
               "outer/anchor", "outer/momentum")


def train_state_from_numpy(state_np, device) -> Dict:
    """The reference's ``launch.train.init_train_state`` pytree, as numpy
    arrays (``jax.device_get``), as the port's train state on ``device``:
    the same nesting, with each parameter tree flattened to
    {path: tensor} (``stack/0/mixer/wq``)."""
    from repro_torch.pytree import flatten

    out: Dict = {}
    for path, arr in flatten(state_np).items():
        head = next((h for h in PARAM_TREES if path.startswith(h + "/")),
                    None)
        node = out
        keys = (head.split("/") if head else path.split("/")[:-1])
        for k in keys:
            node = node.setdefault(k, {})
        node[path[len(head) + 1:] if head else path.split("/")[-1]] = \
            _array(arr).to(device)
    return out


def train_state_to_numpy(state) -> Dict:
    """The port's train state as the reference's pytree of numpy arrays
    (dicts, with the layer stack a tuple over period positions)."""
    from repro_torch.pytree import flatten, unflatten

    return unflatten({k: v.detach().cpu().numpy()
                      for k, v in flatten(state).items()})
