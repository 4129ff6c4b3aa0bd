"""The model inputs of every (arch × shape × mesh) cell, as meta tensors.

The torch counterpart of the reference's ``launch/dryrun.py``'s
``input_specs``.  The reference also lowers and compiles each cell's step
on 512 forced host devices and reads its per-collective bytes from the
HLO; with every mesh axis on one card the port has no such lowering, so
only the inputs are ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_production_mesh, pod_count, rules_for
from repro_torch.models.modality import frontend_input_name


def input_specs(arch: str, shape_name: str, multi_pod: bool = False):
    """Meta-tensor stand-ins for every model input of this cell (shapes
    and dtypes, no memory)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    # dp_only is a training-layout decision; serve shapes keep the 2-D
    # layout (decode batch typically not divisible by all 256 chips)
    profile = cfg.sharding_profile if shape.kind == "train" else "2d"
    rules = rules_for(mesh, long_context=(shape.name == "long_500k"),
                      pod_stacked=(shape.kind == "train"), profile=profile)
    n_pods = pod_count(mesh)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")
        out = {
            "tokens": meta(n_pods, B // n_pods, S),
            "labels": meta(n_pods, B // n_pods, S),
        }
        if cfg.frontend:
            out[frontend_input_name(cfg)] = meta(
                n_pods, B // n_pods, cfg.frontend_len, cfg.d_model,
                dtype=torch.bfloat16)
        return out
    inputs, _ = serve_mod.serve_input_specs(cfg, shape, rules)
    return inputs
