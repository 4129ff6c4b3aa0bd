"""repro_torch's sharded engine (``ShardedTorchEngine``) on the CPU.

The port's counterpart of the reference's sharded-engine checks
(``tests/test_engine_conformance.py`` family 4 and its negative paths,
``tests/test_engine_sharded.py``), each at the reference's tolerance:

* Oracle: at 8 shards on the dyadic subset of
  ``tests/test_torch_conformance.py`` the ``qos_signature`` (quality
  excluded) equals the event oracle's, and the full signature equals the
  torch engine's at ``shards=1``.
* Layout: on the jittered ring16, torus64, cliques32 and smallworld32, 8
  shards equal ``shards=1`` bitwise; so do ``layout="dense"`` (accepted:
  the sharded rings keep one row order), ``W=1``, evo's float32 payloads
  and replicates against the 8-shard edge run.
* One shard: ``ShardedTorchEngine(shards=1)`` equals ``TorchEngine`` at
  ``W=1`` and ``W=4`` (nothing is staged, so no shard can drift).
* The duct ops get contiguous inputs, one call per phase over all shards;
  the hop moves shard blocks by its offset.
* The CLI runs ``--shards 8 --scheduler pipelined``; bad combinations
  raise actionable ``ValueError``s.

The self-paced superstep and pipelined schedulers' checks are in
``tests/test_torch_sharded_superstep.py``.  Bitwise comparisons run a
shorter horizon than the reference's statistical 0.02 s (``BITWISE``):
equality shows at any length.  Runs are cached per process (``_run``), so a
run several properties read executes once.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from engine_cases import (  # noqa: E402
    EXACT_MAX_POPS,
    SCENARIOS_BY_NAME,
    case_seed,
    jittered_cfg,
    oracle,
)
from repro.core.qos import qos_signature as ref_signature  # noqa: E402
from repro_torch.core.qos import qos_signature  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.runtime.config import RunConfig  # noqa: E402
from repro_torch.runtime.engine import make_engine  # noqa: E402
from repro_torch.runtime.engine_sharded import ShardedTorchEngine  # noqa: E402
from repro_torch.runtime.engine_torch import TorchEngine  # noqa: E402
from repro_torch.runtime.experiments import main as cli_main  # noqa: E402
from repro_torch.runtime.faults import FaultModel  # noqa: E402
from test_torch_conformance import SUBSET  # noqa: E402
from torch_cases import (torch_app, torch_cfg, torch_evo_app,  # noqa: E402
                         torch_scenario)

#: the jittered horizon (virtual s) of the bitwise comparisons
BITWISE = 0.006

TOPOLOGIES = (("ring", 16), ("torus", 64), ("cliques", 32),
              ("smallworld", 32))


def jittered(topology, duration, **kw):
    return torch_cfg(jittered_cfg(duration, seed=case_seed(topology), **kw))


@functools.lru_cache(maxsize=None)
def _run(topology, n, duration, mode=None, faults=None, **kw):
    """One jittered graph-coloring run: ``(result, hops, supersteps)``;
    ``kw`` are RunConfig fields, ``mode`` runs with the reference's rolling
    quantum 0.004, ``faults`` is a compute-slowdown item (pid, factor)."""
    cfg_kw = {} if mode is None else dict(mode=mode, rolling_quantum=0.004)
    fm = None if faults is None else FaultModel(
        compute_slowdown=dict([faults]))
    eng = make_engine(RunConfig(engine="torch", **kw),
                      torch_app(n, topology, case_seed(topology)),
                      jittered(topology, duration, **cfg_kw), fm, chunk=64,
                      device="cpu")
    real, calls = mesh.hop, [0]

    def counting(x, off, dim=0, group=None):
        calls[0] += 1
        return real(x, off, dim, group)

    mesh.hop = counting
    try:
        res = eng.run()
    finally:
        mesh.hop = real
    return res, calls[0], eng.windows[-1] // eng.superstep_windows


# ---------------------------------------------------------------------------
# Dyadic: 8 shards give the event oracle's signature
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SUBSET)
def test_8_shards_match_event_oracle_and_one_shard(name):
    scenario = SCENARIOS_BY_NAME[name]

    def run(**kw):
        app, cfg, faults = torch_scenario(scenario)
        return qos_signature(make_engine(
            RunConfig(engine="torch", **kw), app, cfg, faults,
            max_pops=EXACT_MAX_POPS, chunk=64, device="cpu").run())

    got = run(shards=8)
    assert sum(got["updates"]) > 0
    assert got == run(), f"{name}: 8 shards != torch shards=1"
    want = ref_signature(oracle(scenario))
    want.pop("quality")
    got.pop("quality")
    assert got == want, f"{name}: 8 shards != event oracle"


# ---------------------------------------------------------------------------
# Jittered: sharding is a pure layout change
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology,n", TOPOLOGIES,
                         ids=[f"{t}{n}" for t, n in TOPOLOGIES])
def test_jittered_8_shards_equal_one_shard(topology, n):
    r1, hops1, _ = _run(topology, n, BITWISE)
    r8, hops8, supersteps = _run(topology, n, BITWISE, shards=8)
    assert hops1 == 0 and hops8 > 0 and supersteps > 0
    assert qos_signature(r8) == qos_signature(r1), topology


def test_layouts_and_w1_compose_at_8_shards():
    base = qos_signature(_run("torus", 64, BITWISE, shards=8,
                              layout="edge")[0])
    dense = _run("torus", 64, BITWISE, shards=8, layout="dense")[0]
    assert qos_signature(dense) == base, "layout=dense vs edge"
    # superstep_windows=1 rides the auto-resolved scheduler, as on the CLI
    w1 = _run("torus", 64, BITWISE, shards=8, superstep_windows=1)[0]
    assert qos_signature(w1) == base, "superstep_windows=1 vs edge"


def test_evo_float32_payloads_cross_the_hop_bitwise():
    seed = case_seed("torus")
    cfg = jittered("torus", BITWISE)

    def run(**kw):
        return qos_signature(make_engine(
            RunConfig(engine="torch", **kw),
            torch_evo_app(16, "torus", seed, simels=4), cfg, chunk=64,
            device="cpu").run())

    assert run(shards=8) == run()


def test_replicates_at_8_shards_equal_one_shard():
    cfg = jittered("ring", BITWISE / 2)

    def runs(**kw):
        return make_engine(RunConfig(engine="torch", **kw),
                           torch_app(16, "ring", case_seed("ring")), cfg,
                           chunk=64, device="cpu").run_replicates([0, 1, 2])

    reps1, reps8 = runs(), runs(shards=8)
    for i, (a, b) in enumerate(zip(reps1, reps8)):
        assert qos_signature(b) == qos_signature(a), f"replicate {i}"
    assert len({tuple(r.updates) for r in reps8}) > 1


@pytest.mark.parametrize("w", [1, 4])
def test_one_shard_engine_equals_torch_engine(w):
    # with one shard every edge is interior: nothing is staged, so any W
    # reproduces the unsharded engine exactly
    r_plain = _run("ring", 16, BITWISE)[0]
    cfg = jittered("ring", BITWISE)
    eng = ShardedTorchEngine(torch_app(16, "ring", case_seed("ring")), cfg,
                             shards=1, superstep_windows=w, chunk=64,
                             device="cpu")
    assert type(make_engine(RunConfig(engine="torch"),
                            torch_app(16, "ring", case_seed("ring")), cfg,
                            device="cpu")) is TorchEngine
    assert qos_signature(eng.run()) == qos_signature(r_plain)


# ---------------------------------------------------------------------------
# What the sharded path hands the kernels, and the bad combinations
# ---------------------------------------------------------------------------
def test_duct_kernels_get_contiguous_inputs_once_per_phase(monkeypatch):
    """On the card the duct kernels take contiguous tensors of their own
    dtypes; here the plain versions run, so check what the sharded path
    passes them, and that each window phase calls its op once over all
    shards (a W=4 superstep: 4 drains, 3 interior sends, 3 compact and 1
    full push pass)."""
    from repro_torch.kernels.duct_exchange import ops
    from repro_torch.runtime import window_core
    calls = {"drain": 0, "send": 0}

    def checked(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            for a in args:
                assert a.is_contiguous(), (name, a.shape, a.stride())
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(window_core, "duct_drain",
                        checked("drain", ops.duct_drain))
    monkeypatch.setattr(window_core, "duct_send",
                        checked("send", ops.duct_send))
    cfg = jittered("torus", 0.002)
    for layout in ("edge", "dense"):
        calls.update(drain=0, send=0)
        eng = make_engine(RunConfig(engine="torch", shards=8, layout=layout,
                                    superstep_windows=4),
                          torch_app(64, "torus", case_seed("torus")), cfg,
                          chunk=4, device="cpu")
        eng.run()
        supersteps = eng.windows[-1] // 4
        assert calls == {"drain": 4 * supersteps,
                         "send": 7 * supersteps}, (layout, calls)


def test_hops_move_shard_blocks_by_the_offset():
    x = torch.arange(8 * 3).reshape(8, 3)
    for off in (1, 3, 7):
        y = mesh.hop(x, off)
        for i in range(8):
            assert torch.equal(y[(i + off) % 8], x[i])
        assert torch.equal(mesh.hop(y, -off), x)


def test_cli_runs_the_pipelined_sharded_engine_on_cpu(capsys):
    rows = cli_main(["--device", "cpu", "--procs", "16", "--duration",
                     "0.004", "--shards", "8", "--superstep-windows", "4",
                     "--scheduler", "pipelined"])
    assert rows[0]["updates"] > 0
    assert rows[0]["run"]["shards"] == 8
    assert rows[0]["run"]["scheduler"] == "pipelined"
    assert "scheduler=pipelined" in capsys.readouterr().out


def test_bad_combinations_raise_actionable_errors():
    cfg = torch_cfg(jittered_cfg(0.01))
    app = torch_app(16, "ring", 0)
    with pytest.raises(ValueError, match="divide"):
        make_engine(RunConfig(engine="torch", shards=3), app, cfg,
                    device="cpu")
    with pytest.raises(ValueError, match="superstep_windows > 1"):
        make_engine(RunConfig(engine="torch", shards=2,
                              scheduler="pipelined"), app, cfg, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        make_engine(RunConfig(engine="torch", scheduler="pipelined",
                              superstep_windows=8), app, cfg, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        make_engine(RunConfig(engine="torch", scheduler="superstep",
                              superstep_windows=8, layout="edge"), app, cfg,
                    device="cpu")
    with pytest.raises(ValueError, match="scheduler='superstep'"):
        make_engine(RunConfig(engine="torch", scheduler="window", shards=2,
                              superstep_windows=8), app, cfg, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        make_engine(RunConfig(engine="event", shards=8), app, cfg)
    with pytest.raises(ValueError, match=">= 1"):
        ShardedTorchEngine(app, cfg, shards=1, superstep_windows=0,
                           device="cpu")
    with pytest.raises(ValueError, match="superstep_windows > 1"):
        ShardedTorchEngine(app, cfg, shards=1, scheduler="pipelined",
                           device="cpu")
    # the edge layout composes with the sharded superstep scheduler
    eng = make_engine(RunConfig(engine="torch", shards=2, layout="edge",
                                superstep_windows=8), app, cfg, device="cpu")
    assert isinstance(eng, ShardedTorchEngine)
    assert (eng.scheduler, eng.layout) == ("superstep", "edge")
