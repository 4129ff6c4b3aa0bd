"""The dry run (``repro_torch.launch.dryrun``) and the pieces it is built
from, held to the reference.

* Shard shapes: for every arch at full size, on both production meshes
  (a fake group of 256 and of 512 ranks), under the train (pod-stacked),
  serve and ``long_500k`` rules, each parameter's local block under
  ``sharding.param_shardings`` is the reference's
  ``NamedSharding(...).shard_shape``, which one subprocess computes on 512
  forced host devices with a ``jax.sharding.Mesh`` built from
  ``jax.devices()``.
* Per-device bytes: on the (2, 2, 2) debug mesh, ``memory.argument_bytes``
  and ``output_bytes`` of the reduced deepseek-moe-16b train cell in mode 3
  (BEST_EFFORT) and mode 3 int8, the reduced qwen2-1.5b prefill and decode
  cells and the reduced jamba decode under ``long_500k``'s rules equal the
  reference's ``memory_analysis()`` of the same cells, lowered in that
  subprocess as the reference's ``build_lowered`` lowers them; ``flops``
  and ``bytes_accessed`` lie within ``COST_FACTOR`` of its
  ``cost_analysis()``.
* ``collective_bytes`` on hand-built DTensor programs with known
  collectives; ``run_cell``'s keys, its skip reason, ``status: error`` on
  an unknown arch; the CLI on one full-size cell, importing no ``jax``.
* ``lm.param_count`` / ``active_param_count`` for every arch and
  ``outer.maybe_outer_step`` (sync on and off) against the reference's.
* The kernels' shape functions: taken for a ``FakeTensor``, and for a
  meta tensor only within ``build.shape_functions()``; a CPU tensor still
  takes the plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cases  # noqa: E402,F401  (caps torch's threads)
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.smoke import reduce_for_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sharded import local_block  # noqa: E402
from repro_torch.launch import dryrun, mesh, sharding  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import outer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the (2, 2, 2) debug-mesh cells: name -> (arch, shape, mode, compressor,
#: global batch, sequence)
CELLS = {
    "deepseek_train_mode3": ("deepseek-moe-16b", "train_4k", 3, None, 8, 32),
    "deepseek_train_mode3_int8": ("deepseek-moe-16b", "train_4k", 3, "int8",
                                  8, 32),
    "qwen2_prefill": ("qwen2-1.5b", "prefill_32k", 0, None, 8, 32),
    "qwen2_decode": ("qwen2-1.5b", "decode_32k", 0, None, 8, 32),
    "jamba_long_decode": ("jamba-v0.1-52b", "long_500k", 0, None, 1, 64),
}
RULES = ("train", "serve", "long")
#: the dry run's flops and bytes accessed against XLA's cost analysis of
#: the same (2, 2, 2) cells: within this factor either way (measured on
#: a CPU run: 0.39x-1.78x; XLA counts elementwise operations,
#: which these tiny cells are full of, the dry run products only)
COST_FACTOR = 3.0

#: the reference's side, in one process with 512 forced host devices
REFERENCE = textwrap.dedent('''
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS, SHAPES, get_config
    from repro.configs.smoke import reduce_for_smoke
    from repro.core.modes import AsyncMode
    from repro.launch import serve as serve_mod, train as train_mod
    from repro.launch.mesh import rules_for
    from repro.launch.sharding import param_specs, shardings_from_specs, \\
        with_pod_dim
    from repro.models import lm, partitioning

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

    def rules_of(cfg, m, kind):
        if kind == "train":
            return rules_for(m, pod_stacked=True,
                             profile=cfg.sharding_profile)
        return rules_for(m, long_context=(kind == "long"))

    out = {"shards": {}, "bytes": {}, "cost": {}}
    meshes = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
    for arch in ARCHS:
        cfg = get_config(arch)
        like = lm.abstract_params(cfg)
        for mname, (shape, names) in meshes.items():
            m = mesh_of(shape, names)
            for kind in ("train", "serve", "long"):
                specs = param_specs(like, rules_of(cfg, m, kind))
                flat = jax.tree_util.tree_flatten_with_path(like)[0]
                sflat = jax.tree.leaves(specs,
                                        is_leaf=lambda s: isinstance(s, P))
                out["shards"][f"{arch}|{mname}|{kind}"] = {
                    "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path):
                    list(NamedSharding(m, s).shard_shape(leaf.shape))
                    for (path, leaf), s in zip(flat, sflat)}

    m = mesh_of((2, 2, 2), ("pod", "data", "model"))
    for name, (arch, shape_name, mode, comp, B, S) in json.loads(
            sys.argv[1]).items():
        cfg = reduce_for_smoke(get_config(arch))
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=B,
                                    seq_len=S)
        long = shape_name == "long_500k"
        train = shape.kind == "train"
        rules = rules_for(m, long_context=long, pod_stacked=train,
                          profile=cfg.sharding_profile if train else "2d")
        with partitioning.use_rules(rules):
            pspecs = param_specs(lm.abstract_params(cfg), rules)
            if train:
                spec = train_mod.TrainSpec(mode=AsyncMode(mode),
                                           compressor=comp)
                state_like = train_mod.abstract_train_state(cfg, spec, 2)
                ps = with_pod_dim(pspecs)
                sspecs = {"params": ps, "opt": {"m": ps, "v": ps,
                                                "step": P("pod")},
                          "step": P(), "others": ps}
                if comp:
                    sspecs["residuals"] = ps
                batch = {k: jax.ShapeDtypeStruct((2, B // 2, S), jnp.int32)
                         for k in ("tokens", "labels")}
                bspecs = train_mod.make_batch_specs(cfg, rules, 2)
                fn = train_mod.make_train_step(cfg, spec, 2,
                                               param_specs=pspecs)
                c = jax.jit(fn, in_shardings=(
                    shardings_from_specs(sspecs, m),
                    shardings_from_specs(bspecs, m)),
                    out_shardings=(shardings_from_specs(sspecs, m), None),
                    donate_argnums=(0,)).lower(state_like, batch).compile()
            else:
                params = lm.abstract_params(cfg)
                inputs, ispecs = serve_mod.serve_input_specs(cfg, shape,
                                                             rules)
                if shape.kind == "prefill":
                    fn = serve_mod.make_prefill_step(cfg, param_specs=pspecs)
                    c = jax.jit(fn, in_shardings=(
                        shardings_from_specs(pspecs, m),
                        shardings_from_specs(ispecs["tokens"], m))).lower(
                        params, inputs["tokens"]).compile()
                else:
                    fn = serve_mod.make_decode_step(cfg, S - 1,
                                                    param_specs=pspecs)
                    csh = shardings_from_specs(ispecs["caches"], m)
                    c = jax.jit(fn, in_shardings=(
                        shardings_from_specs(pspecs, m),
                        shardings_from_specs(ispecs["tokens"], m), csh),
                        out_shardings=(None, None, csh),
                        donate_argnums=(2,)).lower(
                        params, inputs["tokens"], inputs["caches"]).compile()
        mem, cost = c.memory_analysis(), c.cost_analysis()
        out["bytes"][name] = [mem.argument_size_in_bytes,
                              mem.output_size_in_bytes]
        out["cost"][name] = [cost["flops"], cost["bytes accessed"]]
    print("REFERENCE-JSON " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference():
    """The reference's shard shapes and per-device bytes, computed in one
    subprocess (forced host devices must be set before jax starts)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module", autouse=True)
def no_group_left():
    """The fake group the tests start is gone when the module ends."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_json(reference, port_bytes):
    """(after the port's cells, which run meanwhile)"""
    out, err = reference.communicate(timeout=600)
    assert reference.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines()
                if x.startswith("REFERENCE-JSON "))
    return json.loads(line[len("REFERENCE-JSON "):])


@pytest.fixture(scope="module")
def port_bytes(reference):
    """The port's records of ``CELLS`` (while the reference computes)."""
    out = {}
    for name, (arch, shape_name, mode, comp, B, S) in CELLS.items():
        out[name] = dryrun.run_cell(
            arch, shape_name, True, mode, comp,
            cfg=reduce_for_smoke(get_config(arch)),
            mesh=mesh.make_debug_mesh((2, 2, 2), ("pod", "data", "model")),
            shape=dataclasses.replace(SHAPES[shape_name], global_batch=B,
                                      seq_len=S))
    return out


def rules_of(cfg, m, kind):
    if kind == "train":
        return mesh.rules_for(m, pod_stacked=True,
                              profile=cfg.sharding_profile)
    return mesh.rules_for(m, long_context=(kind == "long"))


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_match_the_reference(ref_json, arch):
    cfg = get_config(arch)
    like = lm.abstract_params(cfg)
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        name = dryrun.mesh_name(m)
        mesh.init_fake_group(512 if multi else 256)
        dmesh = mesh.device_mesh(m)
        for kind in RULES:
            want = ref_json["shards"][f"{arch}|{name}|{kind}"]
            shards = sharding.param_shardings(like, rules_of(cfg, m, kind),
                                              dmesh)
            assert sorted(shards) == sorted(want), (arch, name, kind)
            for path, sh in shards.items():
                got = local_block(like[path].shape, dmesh, sh.placements)[0]
                assert list(got) == want[path], (arch, name, kind, path)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_per_device_bytes_match_the_reference(port_bytes, ref_json, name):
    rec = port_bytes[name]
    assert rec["status"] == "ok", rec.get("error")
    assert [rec["memory"]["argument_bytes"],
            rec["memory"]["output_bytes"]] == ref_json["bytes"][name]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    # flops and bytes accessed are counted otherwise than XLA's
    # cost_analysis (products only, every op unfused), so within a band:
    # a device doing another device's share of the work falls outside it
    flops, accessed = ref_json["cost"][name]
    for got, want in ((rec["flops"], flops),
                      (rec["bytes_accessed"], accessed)):
        assert want / COST_FACTOR <= got <= want * COST_FACTOR, (got, want)


def test_collective_bytes_of_known_programs():
    """Each redistribution of a (16, 8) float32 DTensor on a fake (2, 2)
    mesh issues the collective its placements ask for, with this rank's
    result bytes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    mesh.init_fake_group(4)
    dmesh = mesh.device_mesh(mesh.make_debug_mesh((2, 2), ("data",
                                                           "model")))

    def run(src, dst):
        local = local_block((16, 8), dmesh, src)[0]
        x = DTensor.from_local(torch.empty(local, device="meta"), dmesh,
                               src, run_check=False, shape=(16, 8),
                               stride=(8, 1))
        cost = dryrun.CostMode()
        with implicit_replication(), cost:
            x.redistribute(dmesh, dst)
        return dryrun.collective_bytes(cost.ops)

    R, S0, S1, Pa = Replicate(), Shard(0), Shard(1), Partial()
    assert run((S0, R), (R, R)) == {"all-gather": 16 * 8 * 4}
    assert run((Pa, R), (R, R)) == {"all-reduce": 16 * 8 * 4}
    assert run((Pa, R), (S0, R)) == {"reduce-scatter": 8 * 8 * 4}
    assert run((S0, S1), (R, S1)) == {"all-gather": 16 * 4 * 4}
    assert run((R, R), (S0, R)) == {}
    assert dryrun.collective_bytes([("all_reduce", 8), ("all-reduce", 4),
                                    ("all_to_all_single", 2)]) == {
        "all-reduce": 12, "all-to-all": 2}


def test_pod_group_on_the_fake_backend_stages_nothing():
    """The dry run's pod group: the "pod" axis's subgroup of a fake group
    of 512 ranks, one pod a rank, meta tensors, never pinned host
    buffers; its all-gather of a DTensor keeps the DTensor's layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh.init_fake_group(512)
    dmesh = mesh.device_mesh(mesh.make_production_mesh(multi_pod=True))
    group = mesh.pod_group(dmesh, 2)
    assert (group.size, group.per, group.lo, group.backend) == (2, 1, 0,
                                                               "fake")
    assert not group.staged and group.device.type == "meta"
    sub = dmesh["data", "model"]
    x = DTensor.from_local(torch.empty((1, 4, 8), device="meta"), sub,
                           (Shard(1), Replicate()), run_check=False,
                           shape=(1, 64, 8), stride=(512, 8, 1))
    got = group.all_gather(x, 0)
    assert tuple(got.shape) == (2, 64, 8)
    assert got.placements == x.placements
    assert group.stats["all_gathers"] == 1
    assert group.stats["all_gather_bytes"] == 4 * 8 * 4


def test_run_cell_keys_skip_and_error():
    skipped = dryrun.run_cell("qwen2-1.5b", "long_500k", False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == "skip: long_500k needs sub-quadratic mixing"
    bad = dryrun.run_cell("no-such-arch", "train_4k", False)
    assert bad["status"] == "error" and "no-such-arch" in bad["error"]
    ok = dryrun.run_cell(
        "qwen3-0.6b", "decode_32k", False,
        cfg=reduce_for_smoke(get_config("qwen3-0.6b")),
        mesh=mesh.make_debug_mesh((2, 2), ("data", "model")),
        shape=dataclasses.replace(SHAPES["decode_32k"], global_batch=4,
                                  seq_len=16))
    assert ok["status"] == "ok", ok.get("error")
    assert set(ok) >= {"arch", "shape", "mesh", "mode", "compressor", "tag",
                       "flops", "bytes_accessed", "memory", "collectives",
                       "build_s", "trace_s"}
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes",
                                 "temp_bytes", "peak_bytes"}
    assert ok["mesh"] == "2x2"


def test_cli_on_a_full_size_cell_imports_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["dryrun", "--arch", "qwen3-0.6b", "--shape",
                    "decode_32k", "--mesh", "single", "--out",
                    {str(tmp_path)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun",
                             run_name="__main__")
        except SystemExit as e:
            rc = e.code
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       or m == "repro" for m in sys.modules), "jax imported"
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[dryrun] qwen3-0.6b/decode_32k/16x16: OK" in r.stdout
    assert "[dryrun] done: 1 ok, 0 skipped, 0 errors" in r.stdout
    rec = json.load(open(tmp_path / "qwen3-0.6b__decode_32k__16x16.json"))
    assert rec["status"] == "ok" and rec["memory"]["argument_bytes"] > 0
    assert "traceback" not in rec


@pytest.fixture(scope="module")
def ref_lm():
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm_mod
    return ref_get_config, ref_lm_mod


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(ref_lm, arch):
    ref_get_config, ref_lm_mod = ref_lm
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert lm.param_count(cfg) == ref_lm_mod.param_count(ref_cfg)
    assert lm.active_param_count(cfg) == ref_lm_mod.active_param_count(
        ref_cfg)


@pytest.mark.parametrize("sync", [False, True])
def test_maybe_outer_step_matches_the_reference(sync):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import outer as ref_outer
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal((3, 4, 5)).astype(np.float32)
              for k in ("a", "b")}
    state = {"anchor": {k: rng.standard_normal((3, 4, 5)).astype(np.float32)
                        for k in params},
             "momentum": {k: rng.standard_normal((3, 4, 5))
                          .astype(np.float32) for k in params}}
    cfg = outer.OuterConfig()

    def ref_mean(tree):
        return {k: jnp.broadcast_to(jnp.mean(v, 0, keepdims=True), v.shape)
                for k, v in tree.items()}

    def mean(tree):
        return {k: v.mean(0, keepdim=True).expand_as(v)
                for k, v in tree.items()}

    want_p, want_o = ref_outer.maybe_outer_step(
        params, state, jnp.asarray(sync), ref_mean,
        ref_outer.OuterConfig())
    as_t = {k: torch.as_tensor(v) for k, v in params.items()}
    st = {n: {k: torch.as_tensor(v) for k, v in t.items()}
          for n, t in state.items()}
    got_p, got_o = outer.maybe_outer_step(as_t, st, torch.tensor(sync),
                                          mean, cfg)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=1e-6, atol=1e-6)
        for n in ("anchor", "momentum"):
            np.testing.assert_allclose(got_o[n][k].numpy(),
                                       np.asarray(want_o[n][k]),
                                       rtol=1e-6, atol=1e-6)
        if not sync:
            assert torch.equal(got_p[k], as_t[k])


def test_shape_functions_only_for_fake_inputs():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import (flash_attention_grouped,
                                                     flash_attention_torch)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 2, 8, 16), (2, 8, 16), (2, 8, 16)))
    build.reset_launches()
    out = flash_attention_grouped(q, k, v)          # a CPU tensor: plain
    assert torch.equal(out, flash_attention_torch(q, k, v))
    assert build.FAKE_FLOPS == {} and build.LAUNCHES["flash_attention"] == 0
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        fo = flash_attention_grouped(fq, fk, fv)    # a fake: shape function
    assert fo.shape == q.shape and fo.dtype == q.dtype
    assert build.FAKE_FLOPS["flash_attention"] == 4.0 * 2 * 2 * 8 * 8 * 16
    assert build.LAUNCHES["flash_attention"] == 0
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        flash_attention_grouped(mq, mk, mv)         # meta, outside: raises
    with build.shape_functions():
        mo = flash_attention_grouped(mq, mk, mv)    # meta, inside: shapes
    assert mo.shape == q.shape and mo.device.type == "meta"
    assert build.device_kind(q, "x") == "cpu"
