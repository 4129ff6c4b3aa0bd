"""Multi-pod dry run: every (arch x shape x mesh) cell's step, traced once
on fake tensors over a fake process group of 256 or 512 ranks.

The torch counterpart of the reference's ``launch/dryrun.py``.  The
reference lowers and compiles each cell's SPMD program on 512 forced host
devices and reads XLA's memory analysis, cost analysis and the HLO's
collectives.  Here one process stands for rank 0 of a ``fake`` process
group (``mesh.init_fake_group``: its collectives move nothing), the
production mesh is a ``DeviceMesh`` over it (``mesh.device_mesh``), and
the cell's state, batch and caches are ``DTensor``s of meta tensors (no
data, no memory) placed by the reference's rules for that shape: the
train state on the ("data", "model") axes with the pods over the "pod"
axis's group (``mesh.pod_group``), serving on the whole mesh.  The step is
the port's own (``train.make_train_step``, ``serve.make_prefill_step``,
``serve.make_decode_step``); the kernels take their shape functions
(``build.device_kind``).  One run of it under a dispatch mode that sees
every local op (DTensor's redistributions and collectives included) gives
this rank's record:

* ``flops``: the local matmul-like ops' operations (torch's flop
  registry) plus the kernels' (``build.FAKE_FLOPS``); ``bytes_accessed``:
  every local op's input and output bytes (views excepted);
* ``memory``: ``argument_bytes`` (the inputs' local blocks),
  ``output_bytes`` (the outputs' local blocks, plus 8 bytes a leaf of the
  reference's output tree for the table XLA keeps of them, which its
  ``output_size_in_bytes`` counts), ``peak_bytes`` (the high-water mark of
  the live local storages, inputs included) and ``temp_bytes`` (the peak
  above the arguments);
* ``collectives``: result bytes by kind under the reference's keys
  (``collective_bytes``);
* ``build_s``, ``trace_s``: the time to build the cell and to run it.

The dry run touches no card and calls nothing of ``torch.cuda``.  Its
tensors are meta tensors rather than ``FakeTensor``s: DTensor's own
sharding arithmetic makes small index tensors, which ``FakeTensorMode``
would turn into fakes whose values it cannot read, and autograd on a fake
CUDA tensor needs a CUDA build.  Within the run the kernels take meta
tensors to their shape functions as they take fakes
(``build.shape_functions``, ``build.device_kind``).

Run::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh both          # records under build/dryrun/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core.modes import AsyncMode
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import sharding
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_production_mesh, pod_count, rules_for
from repro_torch.models import lm, partitioning
from repro_torch.models.modality import frontend_input_name
from repro_torch.models.partitioning import is_dtensor
from repro_torch.models.transformer import block_specs

#: build/dryrun at the repository root (git-ignored)
RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "dryrun")

#: the functional collectives' ops, by the reference's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def local_bytes(tree) -> int:
    """The bytes of this rank's blocks of every tensor in ``tree``."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _leaves(tree))


def collective_bytes(ops) -> Dict[str, int]:
    """Result bytes by collective kind (the reference's keys: all-reduce,
    all-gather, reduce-scatter, all-to-all, collective-permute) of
    ``ops``, an iterable of (op name, result bytes): the functional
    collectives' names (``all_gather_into_tensor``) or the kinds
    themselves."""
    out: Dict[str, int] = {}
    for name, nbytes in ops:
        kind = _COLLECTIVES.get(name, name)
        out[kind] = out.get(kind, 0) + int(nbytes)
    return out


def _in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch mode stack."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


class CostMode(TorchDispatchMode):
    """Counts what this rank's local ops do.  A DTensor op is handed back
    (``NotImplemented``) so that DTensor runs it, and its local ops,
    redistributions and collectives come through here on local tensors;
    each is counted: operations (torch's flop registry), bytes in and out,
    collectives (``ops``: (name, result bytes)), and every new storage
    into the live bytes, whose high-water mark is ``peak``.  The ops
    DTensor runs under ``FakeTensorMode`` on the global shapes, to learn
    an output's shape, are not this rank's and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes = 0
        self.ops: list = []
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s local blocks as live."""
        for t in _leaves(tree):
            self._add(_local(t))

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_fake_mode():
            # DTensor's sharding propagation: the op on fakes of the
            # global shapes, run only to read the output's shape
            return out
        packet = func._overloadpacket
        outs = [t for t in _leaves(out)]
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            if name in _COLLECTIVES:
                self.ops.append((name, sum(t.numel() * t.element_size()
                                           for t in outs)))
            return out
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if not func.is_view:
            seen = set()
            for t in list(_leaves((args, kwargs))) + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
            for t in outs:
                self._add(t)
        return out


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run once: ``step(*args)`` on meta
    DTensors; ``weights`` the serving model's (arguments of the
    reference's step, held by the port's model); ``out_leaves(result)``
    the reference's output tree's leaf count."""
    label: str
    rules: object
    step: Callable
    args: tuple
    out_leaves: Callable
    group: Optional[mesh_mod.RankGroup]
    build_s: float
    weights: tuple = ()


def build_cell(arch: str, shape_name: str, multi_pod: bool, mode: int = 0,
               compressor=None, grad_accum: int = 1, remat: bool = True,
               extra_cfg=None, *, cfg=None, mesh=None, shape=None):
    """The counterpart of the reference's ``build_lowered``: (Cell, None),
    or (None, reason) for a cell the shape does not apply to.  It starts
    the fake group of the mesh's ranks (destroying a default group that
    is there) and lays the cell's inputs over it.  ``cfg``, ``mesh`` (a
    ``mesh.Mesh``) and ``shape`` (a ``ShapeConfig``) stand in for the
    arch's config, the production mesh and ``SHAPES[shape_name]`` (the
    tests' reduced cells on the (2, 2, 2) debug mesh)."""
    t0 = time.perf_counter()
    cfg = cfg or get_config(arch)
    if grad_accum > 1:
        cfg = dataclasses.replace(cfg, grad_accum=grad_accum)
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = shape or SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return None, "skip: long_500k needs sub-quadratic mixing"

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    multi_pod = "pod" in mesh.axis_names
    # dp_only is a training-layout decision; serve shapes keep the 2-D
    # layout (decode batch typically not divisible by all 256 chips)
    profile = cfg.sharding_profile if shape.kind == "train" else "2d"
    rules = rules_for(mesh, long_context=(shape.name == "long_500k"),
                      pod_stacked=(shape.kind == "train"), profile=profile)
    n_pods = pod_count(mesh)
    mesh_mod.init_fake_group(math.prod(mesh.shape.values()))
    dmesh = mesh_mod.device_mesh(mesh)
    label = f"{arch}/{shape_name}/{mesh_name(mesh)}"
    like = lm.abstract_params(cfg)
    pspecs = sharding.param_specs(like, rules)

    if shape.kind == "train":
        spec = train_mod.TrainSpec(mode=AsyncMode(mode),
                                   compressor=compressor)
        group = mesh_mod.pod_group(dmesh, n_pods) if multi_pod else None
        per = n_pods if group is None else group.per
        B, S = shape.global_batch, shape.seq_len
        assert B % n_pods == 0
        meta = dict(device="meta")
        batch = {"tokens": torch.empty((per, B // n_pods, S),
                                       dtype=torch.int32, **meta),
                 "labels": torch.empty((per, B // n_pods, S),
                                       dtype=torch.int32, **meta)}
        if cfg.frontend:
            batch[frontend_input_name(cfg)] = torch.empty(
                (per, B // n_pods, cfg.frontend_len, cfg.d_model),
                dtype=torch.bfloat16, **meta)
        state = train_mod.shard_train_state(
            train_mod.abstract_train_state(cfg, spec, per), cfg, spec, rules,
            dmesh)
        batch = train_mod.shard_batch(batch, cfg, rules, dmesh, n_pods)
        step = train_mod.make_train_step(cfg, spec, n_pods, group=group,
                                         param_specs=pspecs)
        n_state = sum(1 for _ in _leaves(state))
        return Cell(label, rules, step, (state, batch),
                    out_leaves=lambda r: n_state + 4, group=group,
                    build_s=time.perf_counter() - t0), None

    n_pos = len(block_specs(cfg))
    dp = rules.roles["dp"] or None
    inputs, in_specs = serve_mod.serve_input_specs(cfg, shape, rules)
    # the reference's serving arguments: the stacked float32 masters,
    # bound into the model inside the step
    weights = sharding.place(like, sharding.shardings_from_specs(pspecs,
                                                                 dmesh))
    model = _model_of(cfg)
    placed = sharding.place(inputs, sharding.shardings_from_specs(
        in_specs, dmesh))

    def batch_out(t):
        # the layout XLA gives the reference's unconstrained outputs of
        # these steps: batch over dp, the rest replicated
        return partitioning.constrain(t, dp, *([None] * (t.ndim - 1)))

    if shape.kind == "prefill":
        prefill = serve_mod.make_prefill_step(model)
        name = frontend_input_name(cfg) if cfg.frontend else None

        def step(tokens, frontend=None):
            serve_mod.bind_stacked(model, weights)
            logits, caches = prefill(tokens, frontend)
            return batch_out(logits), caches

        args = (placed["tokens"],) + ((placed[name],) if name else ())
        return Cell(label, rules, step, args,
                    out_leaves=lambda r: 1 + _stacked_leaves(r[1], n_pos),
                    group=None, build_s=time.perf_counter() - t0,
                    weights=weights), None

    decode = serve_mod.make_decode_step(model, shape.seq_len - 1)

    def dstep(tokens, caches):
        serve_mod.bind_stacked(model, weights)
        nxt, logits, caches = decode(tokens, caches)
        return batch_out(nxt), batch_out(logits), caches

    return Cell(label, rules, dstep, (placed["tokens"], placed["caches"]),
                out_leaves=lambda r: 2 + _stacked_leaves(r[2], n_pos),
                group=None, build_s=time.perf_counter() - t0,
                weights=weights), None


def _model_of(cfg) -> lm.LM:
    """The serving LM's modules, built under ``FakeTensorMode`` (its init
    draws are shapes only); the step binds its weights from the stacked
    float32 masters (``serve.bind_stacked``), as the reference's serving
    step takes them and casts inside."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return lm.LM(cfg, device="cpu")


def _stacked_leaves(caches, n_pos: int) -> int:
    """The leaves of the reference's caches (one per period position and
    name, stacked over periods) for the port's per-layer ``caches``."""
    return sum(len(c) for c in caches[:n_pos])


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def run_cell(arch: str, shape_name: str, multi_pod: bool, mode: int = 0,
             compressor=None, tag: str = "", **kw) -> dict:
    """Build the cell and run its step once: the reference's record keys
    (``status`` "ok", "skipped" or "error"), with ``build_s`` and
    ``trace_s`` in place of ``lower_s`` and ``compile_s``.  ``kw`` goes
    to ``build_cell``."""
    from torch.distributed.tensor.experimental import implicit_replication
    name = mesh_name(kw.get("mesh") or make_production_mesh(
        multi_pod=multi_pod))
    label = f"{arch}/{shape_name}/{name}" + (f"/{tag}" if tag else "")
    record = {"arch": arch, "shape": shape_name, "mesh": name,
              "mode": mode, "compressor": compressor, "tag": tag}
    try:
        cell, skip = build_cell(arch, shape_name, multi_pod, mode,
                                compressor, **kw)
        if skip:
            record["status"] = "skipped"
            record["reason"] = skip
            print(f"[dryrun] {label}: SKIP ({skip})", flush=True)
            return record
        build.reset_launches()
        if cell.group is not None:
            cell.group.reset_stats()
        cost = CostMode()
        t0 = time.perf_counter()
        cost.track((cell.weights, cell.args))
        argument_bytes = local_bytes((cell.weights, cell.args))
        with partitioning.use_rules(cell.rules), implicit_replication(), \
                build.shape_functions(), cost:
            result = cell.step(*cell.args)
        output_bytes = local_bytes(result) + 8 * cell.out_leaves(result)
        trace_s = time.perf_counter() - t0
        ops = list(cost.ops)
        if cell.group is not None:
            # the pod group's all-gathers: each rank's result is the group
            # size times what it sends
            ops.append(("all-gather", cell.group.stats["all_gather_bytes"]
                        * cell.group.size))
        coll = {k: v for k, v in collective_bytes(ops).items() if v}
        flops = cost.flops + sum(build.FAKE_FLOPS.values())
        record.update({
            "status": "ok",
            "flops": flops,
            "bytes_accessed": cost.bytes,
            "memory": {"argument_bytes": argument_bytes,
                       "output_bytes": output_bytes,
                       "temp_bytes": cost.peak - argument_bytes,
                       "peak_bytes": cost.peak},
            "collectives": coll,
            "build_s": round(cell.build_s, 1),
            "trace_s": round(trace_s, 1),
        })
        print(f"[dryrun] {label}: OK flops={flops:.3e} "
              f"coll={sum(coll.values()):.3e}B "
              f"(build {cell.build_s:.0f}s trace {trace_s:.0f}s)",
              flush=True)
    except Exception as e:  # noqa: BLE001 - the record carries it
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-3000:]
        print(f"[dryrun] {label}: ERROR {type(e).__name__}: {str(e)[:300]}",
              flush=True)
    return record


def save_record(record: dict, out_dir: Optional[str] = None) -> str:
    """Write ``record`` (without its traceback) as JSON under ``out_dir``
    (default ``build/dryrun/``); returns the path."""
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            + (f"__{record['tag']}" if record.get("tag") else "") + ".json")
    path = os.path.join(out_dir, name)
    slim = {k: v for k, v in record.items() if k != "traceback"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", type=int, default=0,
                    help="asynchronicity mode for train cells")
    ap.add_argument("--compressor", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ok = err = skip = 0
    try:
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    rec = run_cell(arch, shape, multi, args.mode,
                                   args.compressor, tag=args.tag,
                                   grad_accum=args.grad_accum)
                    save_record(rec, args.out)
                    ok += rec["status"] == "ok"
                    err += rec["status"] == "error"
                    skip += rec["status"] == "skipped"
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {err} errors",
          flush=True)
    return 0 if err == 0 else 1


def input_specs(arch: str, shape_name: str, multi_pod: bool = False):
    """Meta-tensor stand-ins for every model input of this cell (shapes
    and dtypes, no memory)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
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


if __name__ == "__main__":
    raise SystemExit(main())
