"""repro_torch's sharded engine under its self-paced schedulers, on the CPU.

The port's counterpart of ``tests/test_engine_sharded.py``'s superstep and
pipelined checks, at the reference's tolerances:

* At ``W=8`` and 8 shards the hops per superstep equal ``W=1``'s and are
  above 0 (one hop per offset now covers 8 windows), total updates stay
  within 1% of the unsharded run and QoS medians within
  ``SUPERSTEP_QOS_RTOL``, with and without a process slowed 20x.
* Barrier-every-step, rolling, and rolling under ``pipelined`` at ``W=4``
  give the per-window engine's update counts exactly (rolling: the sends
  too), the last also with a crashed clique quarantined (dyadic).
* Pipelined: after the epilogue flush the books balance exactly (attempted
  = accepted + dropped, accepted = delivered + in ring) and every
  ``fly_*`` buffer is empty.

The statistical checks run the reference's 0.02 s horizon; the exact ones
a shorter one (``EXACT``), where barriers still release and the horizon is
still straddled.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (EXACT_MAX_POPS, SCENARIOS_BY_NAME,  # noqa: E402
                          case_seed)
from repro_torch.core.modes import AsyncMode  # noqa: E402
from repro_torch.core.qos import aggregate_reports  # noqa: E402
from repro_torch.interop import carry_to_numpy  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from test_torch_sharded import TOPOLOGIES, _run, jittered  # noqa: E402
from torch_cases import torch_app, torch_scenario  # noqa: E402

#: the reference's superstep (W>1) bound on median QoS against W=1
#: (``tests/test_engine_sharded.py``): batching boundary deliveries to
#: superstep boundaries perturbs drop patterns and per-message handling
#: costs, never the virtual-time stamps
SUPERSTEP_QOS_RTOL = 0.15

#: the reference's jittered horizon for the statistical checks (virtual s)
DURATION = 0.02
#: the horizon of the exact checks: two rolling quanta of 0.004
EXACT = 0.01
#: the horizon of the runs that only count hops (a static count a superstep)
HOPS = 0.002


def _medians_close(ra, rb, label):
    ma, mb = aggregate_reports(ra.qos), aggregate_reports(rb.qos)
    for metric, stats in ma.items():
        a, b = stats["median"], mb[metric]["median"]
        assert (a is None) == (b is None), (label, metric)
        if a is not None:
            assert abs(b - a) <= SUPERSTEP_QOS_RTOL * max(abs(a), 1e-9), (
                label, metric, a, b)


# ---------------------------------------------------------------------------
# Self-paced supersteps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology,n", TOPOLOGIES,
                         ids=[f"{t}{n}" for t, n in TOPOLOGIES])
def test_superstep_w8_amortizes_hops_within_tolerance(topology, n):
    r1 = _run(topology, n, DURATION)[0]
    _, hops1, ss1 = _run(topology, n, HOPS, shards=8)
    rw8, hops8, ss8 = _run(topology, n, DURATION, shards=8,
                           superstep_windows=8)
    # the same hops per superstep while a superstep covers 8x the windows
    assert hops8 / ss8 == hops1 / ss1 > 0, (hops1, ss1, hops8, ss8)
    du = abs(sum(rw8.updates) - sum(r1.updates)) / max(sum(r1.updates), 1)
    assert du < 0.01, (topology, du)
    _medians_close(r1, rw8, f"{topology}{n} W=8")


def test_superstep_w8_with_a_slowed_process():
    # paper-scale latency (~30 windows) keeps the 8-window superstep below
    # the wire latency, where the amortization is QoS-neutral
    slow = (3, 20.0)
    r1 = _run("ring", 16, DURATION, faults=slow)[0]
    rw8 = _run("ring", 16, DURATION, faults=slow, shards=8,
               superstep_windows=8)[0]
    _medians_close(r1, rw8, "ring16 W=8, process 3 slowed 20x")


def test_barrier_and_rolling_w4_are_exact():
    # releases land on superstep boundaries but their times come from
    # frozen waiting clocks, so lockstep barriers are exactly W-invariant
    barrier = AsyncMode.BARRIER_EVERY_STEP
    r1 = _run("ring", 16, EXACT, mode=barrier)[0]
    rw4 = _run("ring", 16, EXACT, mode=barrier, shards=8,
               superstep_windows=4)[0]
    assert rw4.updates == r1.updates, "barrier-every-step W-invariance"
    # rolling barriers meter their quantum on the work clock, so the
    # update schedule cannot drift under W, nor under the pipelined delay
    rolling = AsyncMode.ROLLING_BARRIER
    r1 = _run("ring", 16, EXACT, mode=rolling)[0]
    for sched in ("superstep", "pipelined"):
        rw4 = _run("ring", 16, EXACT, mode=rolling, shards=8,
                   superstep_windows=4, scheduler=sched)[0]
        assert rw4.updates == r1.updates, f"rolling {sched} W-invariance"
        assert rw4.sent == r1.sent, f"rolling {sched} W-invariance (sent)"


def test_rolling_pipelined_w4_with_quarantine_is_exact():
    # the crashed clique is quarantined out of every release; under the
    # pipelined scheduler the gate's cohort front rides the staged
    # decision (rel_ref), and the rolling schedule stays W-invariant
    scenario = SCENARIOS_BY_NAME["cliques-rolling-crash-quarantine"]

    def run(**kw):
        app, cfg, faults = torch_scenario(scenario)
        return make_engine(RunConfig(engine="torch", **kw), app, cfg, faults,
                           max_pops=EXACT_MAX_POPS, chunk=64,
                           device="cpu").run()

    r1 = run()
    rp4 = run(shards=8, superstep_windows=4, scheduler="pipelined")
    assert sum(r1.updates) > 0
    assert rp4.updates == r1.updates and rp4.sent == r1.sent


# ---------------------------------------------------------------------------
# Pipelined scheduler: the books balance after the epilogue flush
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("mode", [AsyncMode.BEST_EFFORT,
                                  AsyncMode.ROLLING_BARRIER],
                         ids=["best-effort", "rolling"])
def test_pipelined_conservation_across_flush(mode, w):
    # the books balance at any horizon; half the exact ones' is enough
    cfg = jittered("torus", EXACT / 2, mode=mode, rolling_quantum=0.004)
    eng = make_engine(RunConfig(engine="torch", shards=8,
                                superstep_windows=w, scheduler="pipelined"),
                      torch_app(64, "torus", case_seed("torus")), cfg,
                      chunk=64, device="cpu")
    carry, _ = eng.run_batch([cfg.seed])
    c = carry_to_numpy(carry)
    res = eng._assemble(c, 0)
    att, ok, drop = (int(np.sum(c[k])) for k in ("c_att", "c_ok", "c_drop"))
    msgs, inring = int(np.sum(c["c_msgs"])), int(np.sum(c["q_size"]))
    assert att == ok + drop, (att, ok, drop)
    assert ok == msgs + inring, (ok, msgs, inring)
    assert res.sent == att and res.dropped == drop
    fly = [k for k in c if k.startswith("fly_")]
    assert fly
    for key in fly:
        assert not np.asarray(c[key]).any(), key
