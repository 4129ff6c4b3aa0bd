"""Checkpoints of a train state, in the reference's on-disk format.  The
counterpart of src/repro/checkpoint/ckpt.py.

``ckpt_dir/step_<k>/`` holds ``arrays.npz`` (each leaf's raw bytes as a
flat uint8 array, keyed by its path: ``params/stack/0/mixer/wq``,
``opt/step``, ``step``, ...) and ``manifest.json`` (the step, and each
leaf's shape and dtype name).  A checkpoint written by either package
restores into the other.  Saves are atomic: written to ``step_<k>.tmp``,
then renamed; a non-blocking save snapshots the state to host memory at
once and writes it from a background thread.  A ``bfloat16`` leaf is
stored as its raw bytes and read back as uint16 viewed as
``torch.bfloat16`` (numpy has no bfloat16 of its own).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.pytree import flatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy (bf16 as its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    """The dtype's name as the reference's manifest writes it (numpy's
    names: "float32", "int32", "bfloat16", ...)."""
    return str(t.dtype).removeprefix("torch.")


def save(ckpt_dir: str, state, step: int, blocking: bool = True):
    """Serialize a state (nested dicts of tensors) to
    ``ckpt_dir/step_<k>`` atomically.  Returns the writer thread when
    ``blocking`` is False, else None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves = flatten(state)
    # snapshot to host memory synchronously, write in the background
    flat = {k: _to_numpy(v) for k, v in leaves.items()}
    dtypes = {k: _dtype_name(v) for k, v in leaves.items()}

    def _write():
        os.makedirs(tmp, exist_ok=True)
        raw = {k: np.atleast_1d(v).view(np.uint8).reshape(-1)
               for k, v in flat.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **raw)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _steps(ckpt_dir: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        a = raw.view(np.uint16).reshape(shape)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape).copy())


def restore(ckpt_dir: str, step: int, like, take=None) -> Dict:
    """Restore into the structure of ``like`` (a state of nested dicts of
    tensors): every leaf of ``like`` is read by its path, checked for its
    shape, cast to its dtype and put on its device.  ``take(path, leaf)``,
    where given, cuts each leaf read (a CPU tensor) to the part ``like``
    holds before the check: a rank's pods of a train state."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, leaf in flatten(like).items():
            meta = manifest["leaves"][key]
            arr = _from_bytes(z[key], meta["dtype"], meta["shape"])
            if take is not None:
                arr = take(key, arr)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(leaf.shape)}")
            out[key] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return _like(like, out)


def _like(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``flat``'s leaves in ``like``'s nesting (dict keys that hold a path
    themselves, like the train state's ``stack/0/mixer/wq``, stay)."""
    if isinstance(like, dict):
        return {k: _like(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    return flat[prefix[:-1]]


def prune(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

