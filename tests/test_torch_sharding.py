"""repro_torch's sharding rules against the reference's.

- ``launch/sharding.param_specs`` for every arch of the registry, on the
  single- and multi-pod production meshes, profiles ``2d`` and
  ``dp_only``, ``pod_stacked`` on and off, ``long_context`` on and off:
  leaf by leaf equal to the reference's ``param_specs`` on its
  ``abstract_params`` (the port's over meta tensors), with
  ``with_pod_dim`` of each.  The meshes are the duck-typed ones
  ``tests/test_launch.py`` uses (axis sizes only), which both packages'
  rules read.
- ``launch/serve.cache_specs`` for every arch (decode_32k, and long_500k
  for the sub-quadratic archs): layer i's spec is the reference's spec of
  its period-stacked leaf without the period entry.
- ``launch/dryrun.input_specs`` on ``test_input_specs_shapes``' three
  cells, and the production meshes and ``rules_for``'s roles on them,
  against the reference's in one subprocess (its dry-run module forces
  512 host devices before JAX starts).
- ``models/partitioning``: ``MeshRules.resolve`` / ``spec``,
  ``use_rules`` / ``active``, and the constraints, which return their
  input (every mesh axis is on one card).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, mesh, serve, sharding  # noqa: E402
from repro_torch.models import lm, partitioning, transformer  # noqa: E402
from repro_torch.models.partitioning import P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    """Duck-typed mesh for spec-rule tests (axis sizes only)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
#: every (profile, pod_stacked, long_context) of ``rules_for``
RULE_CASES = [(profile, stacked, long)
              for profile in ("2d", "dp_only")
              for stacked in (False, True) for long in (False, True)]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import types

    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import get_config as ref_get_config
    from repro.launch import mesh as ref_mesh
    from repro.launch import serve as ref_serve
    from repro.launch import sharding as ref_sharding
    from repro.models import lm as ref_lm
    return types.SimpleNamespace(
        jax=jax, P=PartitionSpec, get_config=ref_get_config, mesh=ref_mesh,
        serve=ref_serve, sharding=ref_sharding, lm=ref_lm)


def ref_flat(ref, tree):
    """The reference's spec tree as {"stack/0/mixer/wq": spec}."""
    flat, _ = ref.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, ref.P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): spec for path, spec in flat}


def assert_specs_equal(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k, w in want.items():
        assert isinstance(got[k], P), (where, k, got[k])
        assert tuple(got[k]) == tuple(w), (where, k, got[k], w)


def both_rules(ref, shape, profile, stacked, long):
    m = _FakeMesh(dict(shape))
    kw = dict(long_context=long, pod_stacked=stacked, profile=profile)
    return ref.mesh.rules_for(m, **kw), mesh.rules_for(m, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_every_arch_mesh_and_profile(ref, arch):
    ref_like = ref.lm.abstract_params(ref.get_config(arch))
    like = lm.abstract_params(get_config(arch))
    assert all(v.device.type == "meta" for v in like.values())
    shapes = {k: tuple(v.shape)
              for k, v in ref_flat(ref, ref_like).items()}
    assert {k: tuple(v.shape) for k, v in like.items()} == shapes
    for mname, shape in MESHES.items():
        for profile, stacked, long in RULE_CASES:
            where = (arch, mname, profile, stacked, long)
            rr, pr = both_rules(ref, shape, profile, stacked, long)
            assert pr.roles == rr.roles, where
            want = ref.sharding.param_specs(ref_like, rr)
            got = sharding.param_specs(like, pr)
            assert_specs_equal(got, ref_flat(ref, want), where)
            assert_specs_equal(sharding.with_pod_dim(got),
                               ref_flat(ref, ref.sharding.with_pod_dim(want)),
                               where)


def test_param_specs_shard_big_dims():
    """``tests/test_launch.py``'s checks, on the port's meta leaves."""
    like = lm.abstract_params(get_config("qwen3-0.6b"))
    rules = partitioning.MeshRules(_FakeMesh(MESHES["single"]),
                                   dp=("data",), tp="model")
    specs = sharding.param_specs(like, rules)
    assert specs["embed"] == P("model", ("data",))
    assert specs["stack/0/mixer/wq"] == P(None, ("data",), "model")
    assert specs["stack/0/mixer/wo"] == P(None, "model", ("data",))
    assert specs["final_norm"] == P(None)


def test_param_specs_fall_back_on_indivisible_dims():
    like = lm.abstract_params(get_config("xlstm-125m"))
    m = _FakeMesh(MESHES["single"])
    specs = sharding.param_specs(
        like, partitioning.MeshRules(m, dp=("data",), tp="model"))
    replicated = 0
    for k, leaf in like.items():
        for dim, axes in zip(leaf.shape, specs[k]):
            if axes is None:
                replicated += 1
                continue
            n = 1
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                n *= m.shape[a]
            assert dim % n == 0, (k, leaf.shape, specs[k])
    assert replicated


def test_with_pod_dim():
    out = sharding.with_pod_dim({"a": P("model"), "b": P(None, ("data",)),
                                 "c": [P(None)]})
    assert out["a"] == P("pod", "model")
    assert out["b"] == P("pod", None, ("data",))
    assert out["c"] == [P("pod", None)]


def cache_cells(cfg):
    cells = [("decode_32k", False)]
    if cfg.sub_quadratic:
        cells.append(("long_500k", True))
    return cells


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_every_arch(ref, arch):
    cfg, rcfg = get_config(arch), ref.get_config(arch)
    n_pos = len(transformer.block_specs(cfg))
    for shape_name, long in cache_cells(cfg):
        s = SHAPES[shape_name]
        for mname, shape in MESHES.items():
            rr, pr = both_rules(ref, shape, "2d", False, long)
            want = ref.serve.cache_specs(
                rcfg, ref.serve.abstract_caches(rcfg, s.global_batch,
                                                s.seq_len), rr)
            want = [ref_flat(ref, pos) for pos in want]
            caches = serve.abstract_caches(cfg, s.global_batch, s.seq_len)
            got = serve.cache_specs(cfg, caches, pr)
            assert len(got) == cfg.num_layers
            for i, layer in enumerate(got):
                w = want[i % n_pos]
                assert set(layer) == set(w), (arch, i)
                for name, spec in layer.items():
                    where = (arch, shape_name, mname, i, name)
                    assert tuple(w[name])[0] is None, where
                    assert tuple(spec) == tuple(w[name])[1:], where
                    assert caches[i][name].device.type == "meta"


@pytest.mark.parametrize("cell", [("llava-next-mistral-7b", "prefill_32k"),
                                  ("jamba-v0.1-52b", "decode_32k"),
                                  ("xlstm-125m", "long_500k")],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_serve_input_specs_match_the_references(ref, cell):
    arch, shape_name = cell
    cfg, rcfg, s = get_config(arch), ref.get_config(arch), SHAPES[shape_name]
    long = shape_name == "long_500k"
    rr, pr = both_rules(ref, MESHES["single"], "2d", False, long)
    _, want = ref.serve.serve_input_specs(rcfg, s, rr)
    inputs, got = serve.serve_input_specs(cfg, s, pr)
    assert set(got) == set(want) == set(inputs)
    for name, spec in got.items():
        if name == "caches":
            n_pos = len(transformer.block_specs(cfg))
            w = [ref_flat(ref, pos) for pos in want[name]]
            for i, layer in enumerate(spec):
                assert {k: tuple(v) for k, v in layer.items()} == {
                    k: tuple(v)[1:] for k, v in w[i % n_pos].items()}, i
        else:
            assert tuple(spec) == tuple(want[name]), name


def test_cache_rule_is_the_references(ref):
    for name in ("k", "v", "C", "conv", "h", "c", "n", "m", "x"):
        for shape in ((2, 4, 8), (2, 4, 8, 16), (2, 4, 8, 128),
                      (2, 4, 8, 16, 32)):
            assert (serve._cache_rule(name, shape)
                    == ref.serve._cache_rule(name, shape)), (name, shape)


def test_partitioning_rules_and_constraints():
    rules = partitioning.MeshRules(_FakeMesh(MESHES["multi"]),
                                   dp=("pod", "data"), tp="model")
    assert rules.resolve(("dp", "sp")) == ("pod", "data", "model")
    assert rules.resolve(None) is None and rules.resolve("x") == "x"
    assert rules.spec("dp", None, "tp") == P(("pod", "data"), None, "model")
    assert partitioning.active() is None
    x = torch.arange(6.0).reshape(2, 3)
    with partitioning.use_rules(rules) as r:
        assert partitioning.active() is r
        assert partitioning.constrain(x, "dp", "tp") is x
        assert partitioning.constrain_spec(x, P(None, "model")) is x
    assert partitioning.active() is None
    assert partitioning.constrain(x, "dp") is x


#: the reference's input specs of ``test_input_specs_shapes``' three cells,
#: and its production meshes with ``rules_for``'s roles, as JSON
REF_SCRIPT = """
import json
from repro.launch.dryrun import input_specs  # forces 512 host devices
from repro.launch.mesh import make_production_mesh, pod_count, rules_for
import jax

def rec(x):
    if isinstance(x, dict):
        return {k: rec(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [rec(v) for v in x]
    return [list(x.shape), str(x.dtype)]

out = {"inputs": {}, "meshes": {}}
for arch, shape, multi in CELLS:
    out["inputs"][f"{arch} {shape} {multi}"] = rec(
        input_specs(arch, shape, multi_pod=multi))
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    roles = {}
    for profile in ("2d", "dp_only"):
        for stacked in (False, True):
            for long in (False, True):
                r = rules_for(m, long_context=long, pod_stacked=stacked,
                              profile=profile)
                roles[f"{profile} {stacked} {long}"] = {
                    k: list(v) if isinstance(v, tuple) else v
                    for k, v in r.roles.items()}
    out["meshes"][str(multi)] = dict(shape=dict(m.shape),
                                     axis_names=list(m.axis_names),
                                     pods=pod_count(m), roles=roles)
print("REF-SPECS " + json.dumps(out))
"""

CELLS = [("qwen2.5-3b", "train_4k", True),
         ("llava-next-mistral-7b", "prefill_32k", False),
         ("jamba-v0.1-52b", "decode_32k", False)]


@pytest.fixture(scope="module")
def ref_specs():
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    script = f"CELLS = {CELLS!r}\n" + textwrap.dedent(REF_SCRIPT)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    line = next(x for x in r.stdout.splitlines()
                if x.startswith("REF-SPECS "))
    return json.loads(line[len("REF-SPECS "):])


def rec(x):
    return [list(x.shape), str(x.dtype).replace("torch.", "")]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_match_the_references(ref_specs, cell):
    arch, shape, multi = cell
    want = ref_specs["inputs"][f"{arch} {shape} {multi}"]
    got = dryrun.input_specs(arch, shape, multi_pod=multi)
    assert set(got) == set(want)
    for name, v in got.items():
        if name != "caches":
            assert v.device.type == "meta"
            assert rec(v) == want[name], (name, rec(v), want[name])
            continue
        cfg = get_config(arch)
        n_pos = len(transformer.block_specs(cfg))
        assert len(v) == cfg.num_layers
        for i, layer in enumerate(v):
            w = want[name][i % n_pos]
            assert set(layer) == set(w)
            for k, t in layer.items():
                shp, dt = w[k]
                assert t.device.type == "meta"
                assert [cfg.num_layers // n_pos] + rec(t)[0] == shp, (i, k)
                assert rec(t)[1] == dt, (i, k)


def test_input_specs_shapes():
    """``tests/test_launch.py::test_input_specs_shapes`` on the port."""
    s = dryrun.input_specs("qwen2.5-3b", "train_4k", multi_pod=True)
    assert s["tokens"].shape == (2, 128, 4096)
    s = dryrun.input_specs("llava-next-mistral-7b", "prefill_32k")
    assert s["tokens"].shape == (32, 32768)
    assert s["patch_embeds"].shape == (32, 576, 4096)
    s = dryrun.input_specs("jamba-v0.1-52b", "decode_32k")
    assert s["tokens"].shape == (128, 1)
    assert "caches" in s


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_and_rules_for(ref_specs, multi):
    want = ref_specs["meshes"][str(multi)]
    m = mesh.make_production_mesh(multi_pod=multi)
    assert m.shape == want["shape"]
    assert list(m.axis_names) == want["axis_names"]
    assert mesh.pod_count(m) == want["pods"]
    for key, roles in want["roles"].items():
        profile, stacked, long = key.split()
        r = mesh.rules_for(m, long_context=long == "True",
                           pod_stacked=stacked == "True", profile=profile)
        got = {k: list(v) if isinstance(v, tuple) else v
               for k, v in r.roles.items()}
        assert got == roles, key
    d = mesh.make_debug_mesh()
    assert d.shape == {"data": 2, "model": 2}
    assert d.axis_names == ("data", "model")
