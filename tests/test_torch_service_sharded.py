"""The sharded engine's serve hook: the arrival table and ``served`` ride
the process permutation into shard order and back.

* 8 shards at ``W=4`` under the ``superstep`` and ``pipelined``
  schedulers equal the reference's ``ShardedJaxEngine`` on the whole
  ``SimResult``, ``service`` included (one subprocess with 8 forced host
  devices, ``engine_cases.run_md``, as in
  ``tests/test_torch_sharded_reference.py``);
* 8 shards per window equal ``shards=1``, on a partition that reorders
  the processes (a relabelled ring) and with a crashed host too.

The configs are ``tests/test_service.py``'s dyadic serve configs.
"""
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (EXACT_MAX_POPS, SCENARIOS_BY_NAME,  # noqa: E402
                          case_seed, dyadic_cfg, run_md)
from repro.core.modes import AsyncMode  # noqa: E402
from repro_torch.apps.graphcolor import (GraphColorApp,  # noqa: E402
                                         GraphColorConfig)
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.topologies import Topology  # noqa: E402
from torch_cases import torch_app, torch_cfg, torch_faults  # noqa: E402

#: (arrival shape, mode name) of tests/test_service.py's exact parity check
CASES = (("poisson", "BEST_EFFORT"), ("diurnal", "BEST_EFFORT"),
         ("bursty", "ROLLING_BARRIER"))
SCHEDULERS = ("superstep", "pipelined")
W = 4
#: the serve fields of tests/test_service.py's dyadic configs
ARRIVALS = dict(arrival_rate=2e5, arrival_bin=2 ** -11,
                arrival_period=2 ** -9, per_item_cost=2 ** -19,
                service_chunk=4)

_REF_SCRIPT = textwrap.dedent(f"""
    import json
    from engine_cases import EXACT_MAX_POPS, case_seed, dyadic_cfg, gc_app
    from repro.core.modes import AsyncMode
    from repro.core.qos import qos_signature
    from repro.runtime.engine_sharded import ShardedJaxEngine

    out = {{}}
    for shape, mode in {CASES[::2]!r}:
        cfg = dyadic_cfg(mode=AsyncMode[mode], seed=case_seed("torus"),
                         arrival_shape=shape, **{ARRIVALS!r})
        for sched in {SCHEDULERS!r}:
            res = ShardedJaxEngine(gc_app(16, "torus"), cfg, shards=8,
                                   superstep_windows={W}, scheduler=sched,
                                   max_pops=EXACT_MAX_POPS, chunk=64).run()
            out[shape + "/" + sched] = dict(qos_signature(res),
                                            service=res.service)
    print("RESULTS " + json.dumps(out))
""")


def _cfg(shape, mode, **kw):
    return torch_cfg(dyadic_cfg(mode=AsyncMode[mode],
                                seed=case_seed("torus"), arrival_shape=shape,
                                **ARRIVALS, **kw))


def _interleaved_ring() -> Topology:
    """A 16-process ring visited 0, 8, 1, 9, ...: contiguous pid blocks
    are far apart on it, so the shard partition reorders the processes."""
    seq = [i // 2 + (8 if i % 2 else 0) for i in range(16)]
    nbs = [()] * 16
    for i, p in enumerate(seq):
        nbs[p] = tuple(sorted((seq[i - 1], seq[(i + 1) % 16])))
    return Topology("ring16-interleaved", 16, tuple(nbs),
                    tuple(p // 4 for p in range(16)))


def _run(cfg, faults=None, topology=None, **run):
    app = (torch_app(16, "torus", case_seed("torus")) if topology is None
           else GraphColorApp(GraphColorConfig(n_processes=16, seed=3),
                              topology=topology))
    eng = make_engine(RunConfig(engine="torch", **run), app, cfg, faults,
                      max_pops=EXACT_MAX_POPS, chunk=64, device="cpu")
    res = eng.run()
    if topology is not None and run.get("shards", 1) > 1:
        # the partition reorders processes, so the table's rows move too
        assert eng.plan.perm != tuple(range(16))
    return dict(qos_signature(res), service=res.service)


@pytest.fixture(scope="module")
def reference():
    out = run_md(_REF_SCRIPT)
    line = next(x for x in out.splitlines() if x.startswith("RESULTS "))
    return json.loads(line[8:])


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("shape,mode", CASES[::2],
                         ids=[s for s, _ in CASES[::2]])
def test_8_shards_equal_the_reference_sharded_engine(reference, shape, mode,
                                                     scheduler):
    got = _run(_cfg(shape, mode), shards=8, superstep_windows=W,
               scheduler=scheduler)
    assert sum(got["service"]["served"]) > 0
    # through JSON as the reference's came: tuples become lists
    got = json.loads(json.dumps(got))
    want = reference[f"{shape}/{scheduler}"]
    assert got == want, (
        f"{shape} {scheduler}: fields differ "
        f"{sorted(k for k in want if got.get(k) != want[k])}")


@pytest.mark.parametrize("shape,mode", CASES, ids=[s for s, _ in CASES])
def test_8_shards_per_window_equal_one(shape, mode):
    cfg = _cfg(shape, mode)
    want = _run(cfg)
    assert sum(want["service"]["served"]) > 0
    assert _run(cfg, shards=8) == want


def test_8_shards_on_a_reordered_partition_equal_one():
    cfg = _cfg("poisson", "BEST_EFFORT")
    topo = _interleaved_ring()
    want = _run(cfg, topology=topo)
    assert sum(want["service"]["served"]) > 0
    assert _run(cfg, topology=topo, shards=8) == want


def test_8_shards_with_a_crashed_host_equal_one():
    scenario = SCENARIOS_BY_NAME["torus-best-effort-crash"]
    cfg = _cfg("poisson", "BEST_EFFORT")
    want = _run(cfg, torch_faults(scenario))
    assert _run(cfg, torch_faults(scenario), shards=8) == want
