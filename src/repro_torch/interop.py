"""Carry state across: a vectorized engine's window carry between numpy
and the torch engine.

The reference engine's carry, after ``jax.device_get``, is a dict of numpy
arrays (the application state nested under ``"app"``); the torch engine's
carry has the same key names and dtypes as torch tensors.  Converting one
into the other lets both engines continue from the identical mid-run state,
the counterpart of carrying weights across for a model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def carry_from_numpy(carry, device) -> Dict:
    """A carry of numpy arrays (nested dicts allowed) as torch tensors on
    ``device``, keeping every key and dtype (bool, int8, int32, float32)."""
    return {k: (carry_from_numpy(v, device) if isinstance(v, dict)
                else torch.as_tensor(np.array(v, copy=True), device=device))
            for k, v in carry.items()}


def carry_to_numpy(carry) -> Dict:
    """A torch carry as nested dicts of numpy arrays (same key names)."""
    return {k: (carry_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in carry.items()}
