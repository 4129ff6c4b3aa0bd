"""repro_torch's best-effort collectives (``core/collectives.py``) against
the reference's under ``shard_map``.

The reference runs on 8 forced host devices in one subprocess, on a
(2, 4) ("pod", "data") mesh with the pod axis manual (partial auto, as its
train step runs them) and on a (2,) ("pod",) mesh; the port runs the same
pod-stacked trees along dimension 0 on the CPU.  Bitwise, leaf by leaf:

- ``exchange_gradients`` in modes 0-4 over two steps from
  ``init_exchange_state`` (effective gradients and the final state), and
  in mode 3 with the int8 and the top-k compressor (the residuals too);
- ``cross_pod_sum`` plain and compressed (int8, top-k), from zero
  residuals and from given ones (the totals and the new residuals; a
  given residual tree is written in place);
- ``pod_mean`` and ``maybe_param_sync`` with the sync on and off.

The trees hold a 3-D leaf (row-wise int8, top-k over its flattened
trailing dims), a 2-D one and a 1-D one (int8 in blocks, top-k as one
row), with magnitudes spanning decades.  ``test_gradient_exchange_modes``'
expected values hold too, on the CPU.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("pod_data", "pod")
COMPRESSORS = {"int8": dict(block=64), "topk": dict(ratio=0.25)}

REF_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import collectives
from repro.core.modes import AsyncMode
from repro.launch.mesh import shard_map  # version-compat wrapper
from repro.optim.compression import get_compressor


def grad_like(rng, shape):
    x = rng.standard_normal(shape)
    x *= 10.0 ** rng.uniform(-6, 0, size=shape[:-1] + (1,))
    return x.astype(np.float32)


rng = np.random.default_rng(0)
SHAPES = {"w": (2, 3, 8, 16), "n/scale": (2, 40), "n/bias": (2, 100)}
inputs = {}
for tag in ("g1", "g2", "res", "params"):
    inputs[tag] = {}
    for k, s in SHAPES.items():
        x = grad_like(rng, s)
        if tag == "res":
            x *= np.float32(1e-3)
        head, *rest = k.split("/")
        if rest:
            inputs[tag].setdefault(head, {})[rest[0]] = x
        else:
            inputs[tag][head] = x
out = {}


def put(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, x in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[f"{prefix}/{name}"] = np.asarray(x)


for tag, tree in inputs.items():
    put(f"in/{tag}", tree)

devs = np.array(jax.devices())
meshes = {"pod_data": Mesh(devs.reshape(2, 4), ("pod", "data")),
          "pod": Mesh(devs[:2], ("pod",))}


def run(mesh, fn, *trees):
    def body(*trees):
        trees = [jax.tree.map(lambda x: x[0], tr) for tr in trees]
        return jax.tree.map(lambda x: jnp.asarray(x)[None], fn(*trees))
    f = jax.jit(shard_map(body, mesh, in_specs=P("pod"), out_specs=P("pod"),
                          axis_names={"pod"}))
    return f(*trees)


g1, g2, res, params = (inputs[k] for k in ("g1", "g2", "res", "params"))
for mname, mesh in meshes.items():
    cases = [(m, None) for m in range(5)] + [(3, c) for c in COMPRESSORS]
    for mode, cname in cases:
        comp = (None if cname is None
                else get_compressor(cname, **COMPRESSORS[cname]))

        def two_steps(a, b):
            mode_ = AsyncMode(mode)
            st = collectives.init_exchange_state(a, mode_, comp)
            e1, st = collectives.exchange_gradients(a, st, mode_, "pod", comp)
            e2, st = collectives.exchange_gradients(b, st, mode_, "pod", comp)
            return {"e1": e1, "e2": e2, "state": st}
        put(f"{mname}/exchange/{mode}/{cname}", run(mesh, two_steps, g1, g2))
    for cname in (None,) + tuple(COMPRESSORS):
        comp = (None if cname is None
                else get_compressor(cname, **COMPRESSORS[cname]))
        put(f"{mname}/sum/{cname}/zero", run(
            mesh, lambda a: collectives.cross_pod_sum(a, "pod", comp), g1))
        if comp is not None:
            put(f"{mname}/sum/{cname}/given", run(
                mesh, lambda a, r: collectives.cross_pod_sum(
                    a, "pod", comp, r), g1, res))
    put(f"{mname}/mean", run(mesh, collectives.pod_mean, params))
    for flag in (False, True):
        put(f"{mname}/sync/{flag}", run(
            mesh, lambda p: collectives.maybe_param_sync(
                p, jnp.asarray(flag), "pod"), params))
np.savez(OUT, **out)
print("REF-COLLECTIVES-OK")
"""


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("collectives") / "ref.npz")
    head = f"COMPRESSORS = {COMPRESSORS!r}\nOUT = {path!r}\n"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c",
                        head + textwrap.dedent(REF_SCRIPT)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "REF-COLLECTIVES-OK" in r.stdout, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


def tree_of(ref_run, tag):
    """The input tree ``tag`` as the port's nested dict of tensors."""
    prefix = f"in/{tag}/"
    out = {}
    for k, v in ref_run.items():
        if k.startswith(prefix):
            head, *rest = k[len(prefix):].split("/")
            x = torch.as_tensor(np.array(v, copy=True))
            if rest:
                out.setdefault(head, {})[rest[0]] = x
            else:
                out[head] = x
    return out


def assert_tree_bitwise(ref_run, prefix, got):
    want = {k[len(prefix) + 1:]: v for k, v in ref_run.items()
            if k.startswith(prefix + "/")}
    got = {k: v for k, v in flatten(got).items() if v is not None}
    assert set(got) == set(want), (prefix, set(got) ^ set(want))
    for k, w in want.items():
        g = np.ascontiguousarray(got[k].numpy())
        assert g.shape == w.shape and g.dtype == w.dtype, (prefix, k)
        bad = g.view(np.uint8).reshape(g.size, -1) != \
            w.view(np.uint8).reshape(w.size, -1)
        assert not bad.any(), \
            f"{prefix}/{k}: {int(bad.any(-1).sum())} of {g.size} differ"


def compressor(name):
    return (None if name is None
            else compression.get_compressor(name, **COMPRESSORS[name]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", [(m, None) for m in range(5)]
                         + [(3, "int8"), (3, "topk")],
                         ids=lambda c: f"mode{c[0]}-{c[1] or 'plain'}")
def test_exchange_gradients_two_steps(ref_run, mesh, case):
    mode, cname = case
    comp = compressor(cname)
    g1, g2 = tree_of(ref_run, "g1"), tree_of(ref_run, "g2")
    st = collectives.init_exchange_state(g1, AsyncMode(mode), comp)
    e1, st = collectives.exchange_gradients(g1, st, AsyncMode(mode), 0, comp)
    e2, st = collectives.exchange_gradients(g2, st, AsyncMode(mode), 0, comp)
    assert_tree_bitwise(ref_run, f"{mesh}/exchange/{mode}/{cname}",
                        {"e1": e1, "e2": e2, "state": st})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cname", [None, "int8", "topk"])
def test_cross_pod_sum(ref_run, mesh, cname):
    comp = compressor(cname)
    g = tree_of(ref_run, "g1")
    total, res = collectives.cross_pod_sum(g, 0, comp)
    assert_tree_bitwise(ref_run, f"{mesh}/sum/{cname}/zero",
                        [total, res] if comp is not None else [total])
    if comp is None:
        assert res is None
        return
    given = tree_of(ref_run, "res")
    kept = flatten(given)
    total, res = collectives.cross_pod_sum(g, 0, comp, given)
    assert_tree_bitwise(ref_run, f"{mesh}/sum/{cname}/given", [total, res])
    # written in place, and the total is one (1, ...) tensor over the pods
    for k, v in flatten(res).items():
        assert v is kept[k]
    for v in flatten(total).values():
        assert v.stride(0) == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_pod_mean_and_param_sync(ref_run, mesh):
    p = tree_of(ref_run, "params")
    assert_tree_bitwise(ref_run, f"{mesh}/mean", collectives.pod_mean(p))
    for flag in (False, True):
        for do_sync in (flag, torch.tensor(flag)):
            assert_tree_bitwise(ref_run, f"{mesh}/sync/{flag}",
                                collectives.maybe_param_sync(p, do_sync))


def test_gradient_exchange_modes_expected_values():
    """``tests/test_core_multidevice.py::test_gradient_exchange_modes``'
    expected values: pod 0's gradient 1, pod 1's 3, then 10 times that."""
    g = torch.tensor([1.0, 3.0])

    def run(mode):
        st = collectives.init_exchange_state(g, mode)
        e1, st = collectives.exchange_gradients(g, st, mode)
        e2, st = collectives.exchange_gradients(g * 10, st, mode)
        return e1.tolist(), e2.tolist()

    assert run(AsyncMode.BARRIER_EVERY_STEP) == ([2.0, 2.0], [20.0, 20.0])
    assert run(AsyncMode.BEST_EFFORT) == ([0.5, 1.5],
                                          [(10 + 3) / 2, (30 + 1) / 2])
    for mode in (AsyncMode.NO_COMM, AsyncMode.ROLLING_BARRIER,
                 AsyncMode.FIXED_BARRIER):
        assert run(mode)[0] == [1.0, 3.0]
