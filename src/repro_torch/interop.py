"""Carry state across: a vectorized engine's window carry between numpy
and the torch engine.

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

from typing import Dict

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
