"""The port's live-service path against the reference's.

On the dyadic serve configs of ``tests/test_service.py`` (arrival bin
2**-11, item cost 2**-19, chunk 4), where float32 and float64 clocks agree
bitwise:

* the arrival streams and the churn schedule (``runtime/service.py``) equal
  the reference's bit for bit;
* the port's event engine equals the reference's on ``service`` and
  ``qos_signature``;
* the torch engine on the CPU (dense and edge, per-window and W = 4
  superstep) equals the reference's jax engine on the whole ``SimResult``,
  ``service`` included, and the port's event oracle on ``service`` and
  ``qos_signature``; a crashed process (its clock at ``+inf``) included;
* one window from the jax engine's carry, arrival table and ``served``
  included, leaves every carry key bitwise equal;
* ``run_service``'s whole output dict (leave / join timeline, two
  replicates, carried app state) equals the reference's, key for key;
* ``python -m repro_torch.runtime.experiments --family serve`` (and
  ``all``) runs on the CPU.

Each reference result is built once per module: every patched epoch
recompiles the jax engine.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    SCENARIOS_BY_NAME,
    case_seed,
    dyadic_cfg,
    gc_app,
)
from repro.apps.graphcolor import GraphColorApp  # noqa: E402
from repro.apps.graphcolor import GraphColorConfig  # noqa: E402
from repro.core.modes import AsyncMode  # noqa: E402
from repro.core.qos import qos_signature as ref_signature  # noqa: E402
from repro.core.slo import SloPolicy as RefSloPolicy  # noqa: E402
from repro.runtime import service as ref_service  # noqa: E402
from repro.runtime.config import RunConfig as RefRunConfig  # noqa: E402
from repro.runtime.engine import make_engine as ref_make_engine  # noqa: E402
from repro.runtime.engine_jax import JaxEngine  # noqa: E402
from repro.runtime.faults import FaultTimeline as RefTimeline  # noqa: E402
from repro.runtime.faults import TimelineEvent as RefEvent  # noqa: E402
from repro.runtime.topologies import make_topology as ref_topology  # noqa: E402
from repro_torch.apps.graphcolor import (  # noqa: E402
    GraphColorApp as TorchGraphColorApp,
    GraphColorConfig as TorchGraphColorConfig,
)
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.core.slo import SloPolicy  # noqa: E402
from repro_torch.interop import carry_from_numpy, carry_to_numpy  # noqa: E402
from repro_torch.runtime import service  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine, run_replicates  # noqa: E402
from repro_torch.runtime.engine_torch import TorchEngine  # noqa: E402
from repro_torch.runtime.experiments import main as cli_main  # noqa: E402
from repro_torch.runtime.faults import FaultTimeline, TimelineEvent  # noqa: E402
from repro_torch.runtime.topologies import (  # noqa: E402
    make_topology,
    patch_topology,
)
from repro_torch.runtime.window_core import arrival_bin_index  # noqa: E402
from torch_cases import (  # noqa: E402
    as_one_replicate,
    torch_app,
    torch_cfg,
    torch_faults,
)

#: the serve scenarios of tests/test_service.py's exact parity check:
#: (arrival shape, mode); poisson keeps clocks lockstep under saturation,
#: rolling barriers pin bursty too
SERVE_CASES = (("poisson", AsyncMode.BEST_EFFORT),
               ("diurnal", AsyncMode.BEST_EFFORT),
               ("bursty", AsyncMode.ROLLING_BARRIER))
#: torch engine variants: RunConfig fields
VARIANTS = {"dense": {}, "edge": {"layout": "edge"},
            "dense-W4": {"superstep_windows": 4}}
#: dyadic scenarios with host 0's processes crashed: their clocks sit at +inf
CRASH_SCENARIOS = ("torus-best-effort-crash", "torus-fixed-crash-quarantine")


def _arrival_cfg(mode=AsyncMode.BEST_EFFORT, shape="poisson", seed=None,
                 **kw):
    """tests/test_service.py's dyadic serve config (reference SimConfig)."""
    base = dict(arrival_rate=2e5, arrival_shape=shape, arrival_bin=2 ** -11,
                arrival_period=2 ** -9, per_item_cost=2 ** -19,
                service_chunk=4)
    base.update(kw)
    return dyadic_cfg(mode=mode, seed=case_seed("torus") if seed is None
                      else seed, **base)


def _full(res):
    """The whole SimResult as one comparable dict."""
    return {**qos_signature(res), "service": res.service,
            "horizon": res.horizon}


def _ref_full(res):
    return {**ref_signature(res), "service": res.service,
            "horizon": res.horizon}


def _torch_run(cfg, topology="torus", faults=None, **run):
    return make_engine(RunConfig(engine="torch", **run),
                       torch_app(16, topology, case_seed(topology)),
                       torch_cfg(cfg), faults, max_pops=EXACT_MAX_POPS,
                       chunk=64, device="cpu").run()


@functools.lru_cache(maxsize=None)
def _ref_jax(shape, mode):
    cfg = _arrival_cfg(mode=mode, shape=shape)
    return _ref_full(ref_make_engine("jax", gc_app(16, "torus"), cfg,
                                     max_pops=EXACT_MAX_POPS).run())


@functools.lru_cache(maxsize=None)
def _port_event(shape, mode):
    cfg = torch_cfg(_arrival_cfg(mode=mode, shape=shape))
    return make_engine("event", torch_app(16, "torus", case_seed("torus")),
                       cfg).run()


# ---------------------------------------------------------------------------
# Arrival streams and churn schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate,bin_", [(2e5, 2 ** -11), (5e3, 1e-3)],
                         ids=["normal-branch", "poisson-branch"])
@pytest.mark.parametrize("shape", ["poisson", "bursty", "diurnal"])
def test_arrival_streams_equal_the_reference(shape, rate, bin_):
    for seed, n in ((0, 16), (7, 15), (1234, 33)):
        ref_cfg = _arrival_cfg(shape=shape, seed=seed, arrival_rate=rate,
                               arrival_bin=bin_, duration=2.0 ** -4)
        cfg = torch_cfg(ref_cfg)
        nb = service.n_bins(cfg)
        assert nb == ref_service.n_bins(ref_cfg)
        for fn, args in ((service.rate_profile, (seed, nb)),
                         (service.arrival_table, (seed, n)),
                         (service.cum_arrivals, (seed, n))):
            want = getattr(ref_service, fn.__name__)(ref_cfg, *args)
            got = fn(cfg, *args)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(
                got.view(np.uint64) if got.dtype == np.float64 else got,
                want.view(np.uint64) if want.dtype == np.float64 else want,
                err_msg=f"{fn.__name__} {shape} seed={seed} n={n}")
        assert service.cum_arrivals(cfg, seed, n)[:, -1].sum() > 0


@pytest.mark.parametrize("topology,n", [("torus", 16), ("ring", 12),
                                        ("cliques", 16), ("smallworld", 32)])
def test_default_timeline_equals_the_reference(topology, n):
    for churn in (0, 1, 2, 5):
        want = ref_service.default_timeline(
            ref_topology(topology, n), churn, 0.05, 20.0, 40.0)
        got = service.default_timeline(make_topology(topology, n), churn,
                                       0.05, 20.0, 40.0)
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events]
        assert (got.compute_factor, got.link_factor) == \
            (want.compute_factor, want.link_factor)


# ---------------------------------------------------------------------------
# Engines on the dyadic serve configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,mode", SERVE_CASES,
                         ids=[s for s, _ in SERVE_CASES])
def test_event_engine_equals_the_reference(shape, mode):
    cfg = _arrival_cfg(mode=mode, shape=shape)
    want = ref_make_engine("event", gc_app(16, "torus"), cfg).run()
    got = _port_event(shape, mode)
    assert got.service is not None and sum(got.service["served"]) > 0
    assert got.service == want.service
    assert qos_signature(got) == ref_signature(want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape,mode", SERVE_CASES,
                         ids=[s for s, _ in SERVE_CASES])
def test_torch_engine_equals_jax_engine_and_event_oracle(shape, mode,
                                                         variant):
    res = _torch_run(_arrival_cfg(mode=mode, shape=shape),
                     **VARIANTS[variant])
    got = _full(res)
    assert sum(got["service"]["served"]) > 0
    want = _ref_jax(shape, mode)
    assert got == want, (
        f"{shape} {variant}: fields differ "
        f"{sorted(k for k in want if got.get(k) != want[k])}")
    ev = _port_event(shape, mode)
    assert res.service == ev.service
    sig, ev_sig = qos_signature(res), qos_signature(ev)
    sig.pop("quality"), ev_sig.pop("quality")
    assert sig == ev_sig


@pytest.mark.parametrize("name", CRASH_SCENARIOS)
def test_crashed_processes_with_arrivals_equal_the_reference(name):
    """A crashed process's clock is +inf: the bin index must saturate at
    the table's last column, as the reference's does."""
    scenario = SCENARIOS_BY_NAME[name]
    cfg = _arrival_cfg(mode=scenario.mode,
                       barrier_timeout=scenario.barrier_timeout)
    want = _ref_full(ref_make_engine(
        "jax", scenario.app(), cfg, scenario.fault_model(),
        max_pops=EXACT_MAX_POPS).run())
    crashed = set(make_topology("torus", 16).host_pids(0))
    for run in ({}, {"layout": "edge"}):
        res = _torch_run(cfg, faults=torch_faults(scenario), **run)
        got = _full(res)
        assert got == want, (name, run)
        for p in crashed:
            assert res.service["served"][p] == 0
            assert res.service["backlog"][p] == res.service["arrivals"][p]
        assert sum(res.service["served"]) > 0


@pytest.mark.parametrize("bin_", [2 ** -11, 1e-3, 3e-4, 7e-5])
def test_arrival_bin_index_is_the_references(bin_):
    """The serve hook's bin index against the reference's expression under
    ``jax.jit``, on clocks in and past the horizon and at ``+inf`` (a
    crashed process), where XLA's cast saturates."""
    nbins = 64
    rng = np.random.default_rng(0)
    t = np.concatenate([
        (rng.random(1 << 20) * nbins * 1.25 * bin_).astype(np.float32),
        (np.arange(nbins + 2) * np.float32(bin_)).astype(np.float32),
        np.array([np.inf], np.float32)])
    want = np.asarray(jax.jit(lambda x: jax.numpy.minimum(
        (x / np.float32(bin_)).astype(jax.numpy.int32), nbins))(t))
    got = arrival_bin_index(torch.from_numpy(t), bin_, nbins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1] == nbins


def test_one_window_from_the_jax_carry():
    cfg = _arrival_cfg()
    seed = case_seed("torus")
    jeng = JaxEngine(gc_app(16, "torus"), cfg, max_pops=EXACT_MAX_POPS)
    teng = TorchEngine(torch_app(16, "torus", seed), torch_cfg(cfg),
                       max_pops=EXACT_MAX_POPS, device="cpu")
    body = jax.jit(lambda c: jeng._window_body_dense(c, None)[0])
    carry = jeng._init_carry(seed)
    init = carry_to_numpy(teng._init_carry(seed))
    assert init["arr_cum"].dtype == np.int32
    np.testing.assert_array_equal(init["arr_cum"],
                                  np.asarray(carry["arr_cum"]))
    # the first bin (2**-11 s) elapses after ~30 updates
    for _ in range(48):
        carry = body(carry)
    start = jax.device_get(carry)
    assert int(np.sum(start["served"])) > 0
    want = jax.device_get(body(carry))
    got = carry_to_numpy(as_one_replicate(
        teng._window_body_dense, carry_from_numpy(start, "cpu")))
    assert sorted(got) == sorted(want)
    for key in ("served", "pending", "t", "steps", "done"):
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(
            b.view(np.uint32) if b.dtype == np.float32 else b,
            a.view(np.uint32) if a.dtype == np.float32 else a, err_msg=key)


def test_no_arrivals_keeps_service_off():
    res = _torch_run(dyadic_cfg(seed=case_seed("torus")))
    assert res.service is None


# ---------------------------------------------------------------------------
# run_service end to end, app state carried across epochs
# ---------------------------------------------------------------------------
def _leave_join(cls, event_cls, cfg):
    return cls((event_cls(t=cfg.duration / 3, kind="leave", pid=5),
                event_cls(t=2 * cfg.duration / 3, kind="join", pid=5)))


def _ref_builder(topology, s, init_state=None):
    return GraphColorApp(
        GraphColorConfig(n_processes=topology.n, nodes_per_process=1,
                         seed=s), topology=topology,
        initial_state=init_state)


def _port_builder(captured=None):
    def build(topology, s, init_state=None):
        if captured is not None:
            captured.append(init_state)
        return TorchGraphColorApp(
            TorchGraphColorConfig(n_processes=topology.n,
                                  nodes_per_process=1, seed=s),
            topology=topology, initial_state=init_state)
    return build


@functools.lru_cache(maxsize=None)
def _ref_service_out(engine):
    cfg = _arrival_cfg()
    return ref_service.run_service(
        RefRunConfig(engine=engine, replicates=2), _ref_builder, cfg,
        ref_topology("torus", 16), _leave_join(RefTimeline, RefEvent, cfg),
        RefSloPolicy())


@pytest.mark.parametrize("run", [
    {"engine": "torch", "layout": "dense"},
    {"engine": "torch", "layout": "edge"},
    {"engine": "torch", "superstep_windows": 4},
    {"engine": "event"}], ids=["dense", "edge", "dense-W4", "event"])
def test_run_service_equals_the_reference(run):
    ref_cfg = _arrival_cfg()
    got = service.run_service(
        RunConfig(replicates=2, **run), _port_builder(), torch_cfg(ref_cfg),
        make_topology("torus", 16),
        _leave_join(FaultTimeline, TimelineEvent, ref_cfg), SloPolicy(),
        device="cpu")
    want = _ref_service_out("event" if run["engine"] == "event" else "jax")
    assert [e["n_procs"] for e in got["epochs"]] == [16, 15, 16]
    assert got["service"]["served"] > 0
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("engine", ["event", "torch"])
def test_app_state_carries_across_epochs(engine):
    """Survivors of a membership change resume from their previous
    epoch's final state; a departed-then-rejoined pid re-initializes
    fresh: the state the epoch-1 builder receives equals a standalone
    epoch-0 run's export, re-keyed through the patch pid map."""
    topo = make_topology("torus", 16)
    cfg = torch_cfg(_arrival_cfg())
    captured = []
    run = RunConfig(engine=engine, replicates=2)
    out = service.run_service(run, _port_builder(captured), cfg, topo,
                              _leave_join(FaultTimeline, TimelineEvent, cfg),
                              device="cpu")
    assert [e["n_procs"] for e in out["epochs"]] == [16, 15, 16]

    # the event path builds one app per replicate, torch one per epoch
    per_epoch = len(captured) // 3
    assert per_epoch == (2 if engine == "event" else 1)
    e1, e2 = captured[per_epoch], captured[2 * per_epoch]
    assert captured[0] is None
    ep1_seeds = run.seeds(cfg.seed + 7919)
    assert sorted(e1) == sorted(ep1_seeds)
    for st in e1.values():
        assert sorted(st) == list(range(15))
        for v in st.values():
            assert all(isinstance(a, np.ndarray) for a in v.values())
    # epoch 2: rejoined pid 5 is not carried; it re-initializes fresh
    assert sorted(e2) == sorted(run.seeds(cfg.seed + 2 * 7919))
    for st in e2.values():
        assert sorted(st) == sorted(set(range(16)) - {5})

    ep0_cfg = dataclasses.replace(
        cfg, duration=cfg.duration / 3,
        snapshot_warmup=min(cfg.snapshot_warmup, cfg.duration / 3 / 6),
        carry_app_state=True)
    res0 = run_replicates(run, lambda s: _port_builder()(topo, s), ep0_cfg,
                          device="cpu")
    _, pid_map = patch_topology(topo, {5})
    for i, s in enumerate(ep1_seeds):
        want = res0[i].app_state
        assert want is not None
        for orig, patched in pid_map.items():
            for key in ("colors", "probs"):
                np.testing.assert_array_equal(e1[s][patched][key],
                                              want[orig][key])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--family", "serve", "--churn", "2", "--traffic", "bursty"],
    ["--family", "serve", "--churn", "1", "--shards", "4",
     "--superstep-windows", "2", "--scheduler", "pipelined"],
    ["--family", "serve", "--engine", "event", "--churn", "2"],
    ["--family", "all", "--intensivity-simels", "1", "4", "--churn", "2"],
], ids=["serve", "serve-sharded-pipelined", "serve-event", "all"])
def test_cli_serve_runs_on_cpu(argv, capsys):
    rows = cli_main(["--device", "cpu", "--procs", "16", "--duration",
                     "0.004", *argv])
    serve = [r for r in rows if r["family"] == "serve"]
    assert len(serve) == 1
    row = serve[0]
    churn = int(argv[argv.index("--churn") + 1])
    assert len(row["epochs"]) == 2 * churn + 1
    svc = row["service"]
    assert svc["arrivals"] == svc["served"] + svc["backlog"] > 0
    out = capsys.readouterr().out
    assert "  slo: " in out and "  service: " in out
    if "all" in argv:
        assert [r["family"] for r in rows][-1] == "serve"
        assert {r["family"] for r in rows} == {
            "modes", "weak_scaling", "intensivity", "faults", "serve"}
