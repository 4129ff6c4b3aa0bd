"""repro_torch's sharded engine against the reference's ``ShardedJaxEngine``.

One subprocess with 8 forced host devices (``engine_cases.run_md``; the
main test process keeps one XLA device) runs the reference's sharded
engine at 8 shards, ``W=4``, under the ``superstep`` and the ``pipelined``
scheduler, on three dyadic scenarios, and prints their ``qos_signature``s
as JSON.  The port's runs on the CPU must equal them bitwise, quality
included: the clocks are dyadic, so no libm ulp enters a trajectory.
"""
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (EXACT_MAX_POPS, SCENARIOS_BY_NAME,  # noqa: E402
                          run_md)
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from torch_cases import torch_scenario  # noqa: E402

SCENARIOS = ("torus-best-effort", "smallworld-barrier-lossy",
             "ring-rolling-barrier")
SCHEDULERS = ("superstep", "pipelined")
W = 4

_REF_SCRIPT = textwrap.dedent(f"""
    import json
    from engine_cases import SCENARIOS_BY_NAME, run_case
    from repro.core.qos import qos_signature
    from repro.runtime.engine_sharded import ShardedJaxEngine

    sigs = {{}}
    for name in {SCENARIOS!r}:
        for sched in {SCHEDULERS!r}:
            s = SCENARIOS_BY_NAME[name]
            eng = ShardedJaxEngine(s.app(), s.config(), s.fault_model(),
                                   shards=8, superstep_windows={W},
                                   scheduler=sched, max_pops={EXACT_MAX_POPS},
                                   chunk=64)
            sigs[name + "/" + sched] = qos_signature(eng.run())
    print("SIGS " + json.dumps(sigs))
""")


@pytest.fixture(scope="module")
def reference():
    out = run_md(_REF_SCRIPT)
    line = next(x for x in out.splitlines() if x.startswith("SIGS "))
    return json.loads(line[5:])


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_8_shards_equal_the_reference_sharded_engine(reference, name,
                                                     scheduler):
    app, cfg, faults = torch_scenario(SCENARIOS_BY_NAME[name])
    got = qos_signature(make_engine(
        RunConfig(engine="torch", shards=8, superstep_windows=W,
                  scheduler=scheduler),
        app, cfg, faults, max_pops=EXACT_MAX_POPS, chunk=64,
        device="cpu").run())
    assert sum(got["updates"]) > 0
    # through JSON as the reference's came: tuples become lists
    got = json.loads(json.dumps(got))
    want = reference[f"{name}/{scheduler}"]
    assert got == want, (
        f"{name} {scheduler}: fields differ "
        f"{sorted(k for k in want if got.get(k) != want[k])}")
