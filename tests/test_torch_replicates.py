"""Batched replicates: one chunk loop and one duct launch a window serve
every seed.

``TorchEngine.run_replicates`` (and the sharded engine's) runs a sweep of
seeds as one batch, every carry leaf with a leading replicate axis as the
reference's ``jax.vmap`` gives it.  On the dyadic configs of
``engine_cases`` (no jitter: every float is exact on every device):

- every ``SimResult`` field of every replicate equals the sequential
  loop's (``run_replicates_sequential``: one batch of one a seed) bit for
  bit, on the dense window, the W = 4 superstep and the edge-major layout,
  under a barrier mode and under lossy, flapping and crashed hosts, with
  seeds whose replicates stop in different chunks;
- the batch equals the reference's vmapped ``JaxEngine.run_replicates`` at
  the same seeds, quality included (``tests/test_engine_jax.py``'s
  replicate test, held bitwise);
- ``--shards 8`` batched equals ``--shards 1`` batched
  (``tests/test_engine_conformance.py``'s replicate check, bitwise);
- the plain duct calls a window do not depend on R (counted by wrapping
  the ops where the window core calls them, as ``profile_window`` counts
  the kernels);
- evo's float32 halos (``duct_window_f32``, ``duct_commit_f32``) batch
  the same way, and the live service's epochs (carried app state, SLO
  inputs) give the same output batched as seed by seed;
- a release that reduces over the whole batch instead of each replicate
  couples the seeds, and the bitwise check catches it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)
from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    QUARANTINE_TAU,
    Scenario,
    case_seed,
    dyadic_cfg,
)
from repro.core.modes import AsyncMode  # noqa: E402
from repro.runtime.engine_jax import JaxEngine  # noqa: E402

from repro_torch.apps.graphcolor import (  # noqa: E402
    GraphColorApp,
    GraphColorConfig,
)
from repro_torch.core.slo import SloPolicy  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    engine_torch,
    service,
    window_core,
)
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultTimeline,
    TimelineEvent,
)
from repro_torch.runtime.topologies import make_topology  # noqa: E402
from torch_cases import (assert_same, torch_cfg,  # noqa: E402
                         torch_evo_app, torch_scenario)

SEEDS = (0, 1, 2, 3)
#: windows a chunk: small, so that replicates can stop in different chunks
CHUNK = 8
#: the runs' horizon: half the dyadic configs' 2**-7 (the file's time)
HORIZON = 2.0 ** -8

BARRIER = AsyncMode.BARRIER_EVERY_STEP
SCENARIOS = [
    Scenario("torus-best-effort", "torus"),
    Scenario("smallworld-barrier", "smallworld", mode=BARRIER),
    Scenario("ring-best-effort-lossy", "ring", faults="lossy25"),
    Scenario("smallworld-barrier-lossy", "smallworld", mode=BARRIER,
             faults="lossy25"),
    Scenario("ring-best-effort-flap", "ring", faults="flap50"),
    Scenario("torus-best-effort-crash", "torus", faults="crash0"),
    Scenario("ring-barrier-crash-quarantine", "ring", mode=BARRIER,
             faults="crash0", barrier_timeout=QUARANTINE_TAU),
]
#: engine variants: the dense window, the W = 4 superstep, the edge layout
VARIANTS = {
    "dense": dict(),
    "superstep4": dict(scheduler="superstep", superstep_windows=4),
    "edge": dict(layout="edge"),
}
#: (scenario, variant): every scenario on the dense window, and the other
#: two paths each under a barrier mode and a fault
CASES = ([(sc, "dense") for sc in SCENARIOS] +
         [(SCENARIOS[i], "superstep4") for i in (0, 3, 5)] +
         [(SCENARIOS[i], "edge") for i in (1, 4, 6)])


def signature(res):
    """What tells two replicates apart: updates, drops and the final
    colors of every process."""
    colors = b"".join(res.app_state[p]["colors"].tobytes()
                      for p in sorted(res.app_state))
    return tuple(res.updates) + (res.dropped, colors)


def port_engine(scenario, horizon=HORIZON, **kw):
    """The port's engine of ``scenario`` (exporting the final app state,
    so that results compare it too) at ``horizon`` (None: the scenario's),
    on the CPU."""
    app, cfg, faults = torch_scenario(scenario)
    cfg = dataclasses.replace(cfg, carry_app_state=True,
                              duration=horizon or cfg.duration)
    kw.setdefault("max_pops", EXACT_MAX_POPS)
    return make_engine(RunConfig(engine="torch", **{
        k: v for k, v in kw.items() if k != "max_pops" and k != "chunk"}),
        app, cfg, faults, max_pops=kw["max_pops"],
        chunk=kw.get("chunk", CHUNK), device="cpu")


@pytest.mark.parametrize("scenario,variant", CASES,
                         ids=[f"{sc.name}-{v}" for sc, v in CASES])
def test_batched_equals_sequential_bitwise(scenario, variant):
    eng = port_engine(scenario, **VARIANTS[variant])
    batched = eng.run_replicates(SEEDS)
    needed = eng.windows_needed[-len(SEEDS):]
    assert all(w == eng.windows[-1] for w in eng.windows[-len(SEEDS):])
    assert max(needed) == eng.windows[-1]
    sequential = port_engine(scenario, **VARIANTS[variant]
                             ).run_replicates_sequential(SEEDS)
    for r, (want, got) in enumerate(zip(sequential, batched)):
        assert_same(want, got, f"replicate {r}")
    # the seeds really differ
    assert len({signature(res) for res in batched}) == len(SEEDS)


#: seeds of this lossy torus stop in different windows (472 or 473, at
#: the dyadic configs' own horizon)
STAGGERED = Scenario("torus-best-effort-lossy", "torus", faults="lossy25")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_replicates_stop_in_different_chunks(variant):
    """Replicates that stop in different chunks (one window a chunk, or one
    superstep): those that stop first run state-invariant windows until
    the last one stops, ``windows_needed`` says where each stopped, and
    each equals its own single run."""
    kw = dict(VARIANTS[variant], chunk=1, horizon=None)
    eng = port_engine(STAGGERED, **kw)
    batched = eng.run_replicates(SEEDS)
    needed = eng.windows_needed[-len(SEEDS):]
    assert len(set(needed)) > 1, needed
    assert max(needed) == eng.windows[-1]
    single = port_engine(STAGGERED, **kw)
    for r, s in enumerate(SEEDS):
        assert_same(single.run_replicates([s])[0], batched[r],
                    f"replicate {r}")
        assert single.windows_needed[-1] == needed[r]


def test_one_seed_is_a_batch_of_one():
    """``run`` is ``run_replicates`` of the config's seed, a batch of one
    whose carry keeps the replicate axis."""
    scenario = SCENARIOS[0]
    eng = port_engine(scenario)
    one = eng.run_replicates([scenario.seed()])[0]
    assert_same(port_engine(scenario).run(), one)
    carry, windows = port_engine(scenario).run_batch([scenario.seed()])
    assert tuple(carry["seed"].shape) == (1,)
    assert carry["t"].shape[0] == 1 and windows == eng.windows[-1]


@pytest.mark.parametrize("scenario", SCENARIOS[:2] + SCENARIOS[4:6],
                         ids=lambda s: s.name)
def test_batched_equals_reference_vmapped_replicates(scenario):
    """The reference's ``JaxEngine.run_replicates`` (one vmapped scan) and
    the port's batch at the same seeds: every field, quality included."""
    cfg = dataclasses.replace(scenario.config(), carry_app_state=True,
                              duration=HORIZON)
    want = JaxEngine(scenario.app(), cfg, scenario.fault_model(),
                     max_pops=EXACT_MAX_POPS,
                     chunk=CHUNK).run_replicates(list(SEEDS))
    got = port_engine(scenario).run_replicates(SEEDS)
    for r, (a, b) in enumerate(zip(want, got)):
        a = dataclasses.replace(a, quality=float(a.quality))
        assert_same(a, b, f"replicate {r}")
    assert len({signature(res) for res in got}) == len(SEEDS)


@pytest.mark.parametrize("scheduler,w", [("window", 1), ("superstep", 4),
                                         ("pipelined", 4)])
@pytest.mark.parametrize("scenario", [SCENARIOS[0], SCENARIOS[3]],
                         ids=lambda s: s.name)
def test_sharded_batched_equals_unsharded_batched(scenario, scheduler, w):
    """``--shards 8`` batched against ``--shards 1`` batched, bitwise, as
    the reference's conformance suite holds its vmapped shards; the
    superstep schedulers against themselves at one shard count and the
    sequential loop."""
    kw = dict(superstep_windows=w, scheduler=scheduler)
    if scheduler == "window":
        want = port_engine(scenario, layout="edge").run_replicates(SEEDS)
    else:
        want = port_engine(scenario, shards=8, **kw
                           ).run_replicates_sequential(SEEDS)
    got = port_engine(scenario, shards=8, **kw).run_replicates(SEEDS)
    for r, (a, b) in enumerate(zip(want, got)):
        assert_same(a, b, f"replicate {r}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_evo_float32_halos_batch_bitwise(variant):
    """Evo's float32 payloads through the batched window, superstep and
    edge paths, against the sequential loop."""
    seed = case_seed("torus")
    cfg = dataclasses.replace(torch_cfg(dyadic_cfg(seed=seed)),
                              duration=2.0 ** -9)
    kw = VARIANTS[variant]

    def engine():
        return make_engine(RunConfig(engine="torch", **kw),
                           torch_evo_app(16, "torus", seed, simels=4), cfg,
                           max_pops=EXACT_MAX_POPS, chunk=CHUNK,
                           device="cpu")

    batched = engine().run_replicates(SEEDS)
    sequential = engine().run_replicates_sequential(SEEDS)
    for r, (want, got) in enumerate(zip(sequential, batched)):
        assert_same(want, got, f"replicate {r}")
    assert len({r.quality for r in batched}) == len(SEEDS)


def test_service_epochs_batch_as_seed_by_seed(monkeypatch):
    """The live service (a leave and a rejoin: three epochs, the app
    state of the processes that stay carried per replicate) gives the
    same output when every epoch's replicates run as one batch as when
    they run seed by seed."""
    cfg = torch_cfg(dyadic_cfg(
        seed=case_seed("torus"), arrival_rate=2e5, arrival_shape="poisson",
        arrival_bin=2 ** -11, arrival_period=2 ** -9,
        per_item_cost=2 ** -19, service_chunk=4))
    timeline = FaultTimeline((
        TimelineEvent(t=cfg.duration / 3, kind="leave", pid=5),
        TimelineEvent(t=2 * cfg.duration / 3, kind="join", pid=5)))

    def build(topology, s, init_state=None):
        return GraphColorApp(GraphColorConfig(
            n_processes=topology.n, nodes_per_process=1, seed=s),
            topology=topology, initial_state=init_state)

    def run():
        return service.run_service(
            RunConfig(engine="torch", replicates=3), build, cfg,
            make_topology("torus", 16), timeline, SloPolicy(),
            device="cpu", max_pops=EXACT_MAX_POPS)

    batched = run()
    monkeypatch.setattr(engine_torch.TorchEngine, "run_replicates",
                        engine_torch.TorchEngine.run_replicates_sequential)
    assert [e["n_procs"] for e in batched["epochs"]] == [16, 15, 16]
    assert batched["service"]["served"] > 0
    assert_same(run(), batched)


def count_duct_calls(monkeypatch):
    """Wrap the duct ops where the window core calls them; returns the
    live counts."""
    calls = {}
    for name in ("duct_window", "duct_commit", "duct_drain", "duct_send"):
        real = getattr(window_core, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(window_core, name, counted)
    return calls


@pytest.mark.parametrize("kw", [dict(), dict(scheduler="superstep",
                                             superstep_windows=4),
                                dict(layout="edge"),
                                dict(shards=8, superstep_windows=4)],
                         ids=["dense", "superstep4", "edge", "shards8"])
def test_duct_calls_a_window_do_not_depend_on_r(monkeypatch, kw):
    calls = count_duct_calls(monkeypatch)
    scenario = SCENARIOS[2]
    per_window = {}
    for reps in (1, 4):
        calls.clear()
        eng = port_engine(scenario, **kw)
        eng.run_replicates(SEEDS[:reps])
        per_window[reps] = {k: v / eng.windows[-1] for k, v in calls.items()}
    assert per_window[1] == per_window[4]
    assert sum(per_window[4].values()) > 0


def test_pooled_release_couples_the_seeds(monkeypatch):
    """The release reductions are per replicate: pooled over the whole
    batch, a barrier release waits for every seed's cohort, and the
    batched results leave the sequential ones."""
    scenario = SCENARIOS[3]
    want = port_engine(scenario).run_replicates_sequential(SEEDS)
    release = window_core.LocalRelease

    def pooled(reduce):
        def run(self, x):
            return reduce(x.reshape(-1)).reshape(1, 1).expand(
                x.shape[0], 1)
        return run

    monkeypatch.setattr(release, "all_stopped", pooled(torch.all))
    monkeypatch.setattr(release, "any_waiting", pooled(torch.any))
    monkeypatch.setattr(release, "max_time", pooled(torch.amax))
    got = port_engine(scenario).run_replicates(SEEDS)
    with pytest.raises(AssertionError):
        for r, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"replicate {r}")
