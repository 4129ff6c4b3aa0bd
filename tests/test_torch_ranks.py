"""The sharded engine's shard axis over ``torch.distributed`` ranks.

Two and four gloo ranks on the CPU (``rank_cases``: spawned once per rank
count, one torch thread each, a ``file://`` store), while the test
process computes the one-process results and, in a subprocess, the
reference's.  Bitwise:

* ``mesh.hop`` over the ranks is ``torch.roll`` of the gathered tensor, at
  offsets +-1 and +-3 (and 5) along dimensions 0 and 1, with one and two
  blocks a rank, on int32, float32 and bool blocks;
* ``RankRelease`` and ``PipelinedRankRelease`` equal ``LocalRelease`` on
  the gathered tensors: each reduction alone and each ``reduce`` a close
  phase issues, with -inf and +inf clocks;
* ``ShardedTorchEngine`` at 8 shards over 2 and 4 ranks equals 8 shards
  in one process on every ``SimResult`` field (and every rank returns the
  whole result), with the same windows executed and needed, on the dyadic
  ``torus-best-effort``, ``smallworld-barrier-lossy`` and
  ``ring-rolling-barrier`` under the ``window``, ``superstep`` (W = 4)
  and ``pipelined`` (W = 4) schedulers, and at R = 3 replicates; the runs
  went through the ranks (hops sent bytes to peers, the carry was
  gathered, barrier runs all-reduced);
* the reference's 8-device ``ShardedJaxEngine`` gives the 2-rank port's
  ``qos_signature``, quality included, on ``smallworld-barrier-lossy``
  under ``window`` (every window a release over the ranks);
* the rank path refuses what it cannot do: NCCL with more ranks than
  cards, shards that do not split over the ranks, a backend that is not
  the group's, an engine whose shards are not the group's, a group
  without shards, a hop of the wrong block count.

The scenarios run at a horizon of 2**-8 s (``HORIZON``, the scenarios'
own is 2**-7): the equality is bitwise, so it shows at any length, and a
gloo exchange costs about a millisecond on one host (the file takes ~70 s
at 2**-7 on an idle 8-core host, ~40 s at 2**-8).
"""
import concurrent.futures
import dataclasses
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import rank_cases  # noqa: E402
from engine_cases import SCENARIOS_BY_NAME, run_md  # noqa: E402
from repro_torch.core.qos import qos_signature  # noqa: E402
from torch_cases import assert_same, torch_cfg, torch_faults  # noqa: E402

WORLDS = (2, 4)
SHARDS = 8
SCENARIOS = ("torus-best-effort", "smallworld-barrier-lossy",
             "ring-rolling-barrier")
SCHEDULERS = {"window": {},
              "superstep": dict(superstep_windows=4),
              "pipelined": dict(superstep_windows=4, scheduler="pipelined")}
#: the virtual horizon (s) of every engine case
HORIZON = 2.0 ** -8
#: the replicate cases: this scenario under every scheduler, three seeds
REPLICATE_SCENARIO = "ring-rolling-barrier"
#: the case held against the reference's sharded engine
REFERENCE_CASE = ("smallworld-barrier-lossy", "window")


def spec(name, scheduler, replicates=False):
    s = SCENARIOS_BY_NAME[name]
    cfg = dataclasses.replace(torch_cfg(s.config()), duration=HORIZON)
    seeds = (s.seed(), s.seed() + 1, s.seed() + 2) if replicates else None
    return (s.n, s.topology, s.seed(), cfg, torch_faults(s),
            dict(shards=SHARDS, **SCHEDULERS[scheduler]), seeds)


SPECS = {(name, sched): spec(name, sched)
         for name in SCENARIOS for sched in SCHEDULERS}
SPECS.update({(REPLICATE_SCENARIO, sched, "R=3"): spec(
    REPLICATE_SCENARIO, sched, replicates=True) for sched in SCHEDULERS})

_REF_SCRIPT = textwrap.dedent(f"""
    import dataclasses, json
    from engine_cases import SCENARIOS_BY_NAME
    from repro.core.qos import qos_signature
    from repro.runtime.engine_sharded import ShardedJaxEngine

    s = SCENARIOS_BY_NAME[{REFERENCE_CASE[0]!r}]
    cfg = dataclasses.replace(s.config(), duration={HORIZON!r})
    eng = ShardedJaxEngine(s.app(), cfg, s.fault_model(), shards={SHARDS},
                           superstep_windows=1, scheduler="window",
                           max_pops=64, chunk=64)
    print("SIG " + json.dumps(qos_signature(eng.run())))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read: the ranks' results per rank count, the
    one-process results and the reference's signature, computed at
    once."""
    tmp = tmp_path_factory.mktemp("ranks")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_md, _REF_SCRIPT)
        spawned = {w: rank_cases.start(w, tmp, "engine_cases", SPECS)
                   for w in WORLDS}
        single = {key: rank_cases.engine_result(s) for key, s in
                  SPECS.items()}
        ranks = {w: r.results() for w, r in spawned.items()}
        line = next(x for x in ref.result().splitlines()
                    if x.startswith("SIG "))
    return dict(ranks=ranks, single=single, reference=json.loads(line[4:]))


@pytest.mark.parametrize("case", rank_cases.HOP_CASES,
                         ids=lambda c: "per{}-dim{}-off{}-{}".format(*c))
@pytest.mark.parametrize("world", WORLDS)
def test_hop_equals_roll_of_the_gathered_tensor(runs, world, case):
    per, dim, off, dtype = case
    x = rank_cases.hop_input(world, per, dim, dtype)
    got = torch.cat([r["hop"][case] for r in runs["ranks"][world]], dim=dim)
    assert got.dtype == x.dtype
    assert torch.equal(got, torch.roll(x, off, dim))


@pytest.mark.parametrize("strategy", ("rank", "pipelined"))
@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_releases_equal_local_release(runs, world, seed, strategy):
    want = rank_cases.local_releases(world, seed)
    for rank, r in enumerate(runs["ranks"][world]):
        got = r["release"][(strategy, seed)]
        for name in want:
            w, g = want[name], got[name]
            if isinstance(w, tuple):
                w = [w[0], w[1], *w[2]]
                g = [g[0], g[1], *g[2]]
            else:
                w, g = [w], [g]
            for a, b in zip(w, g):
                assert (a is None) == (b is None), (rank, name)
                if a is not None:
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert torch.equal(a.view(torch.uint8)
                                       if a.dtype == torch.bool else a,
                                       b.view(torch.uint8)
                                       if b.dtype == torch.bool else b), (
                        rank, name)


@pytest.mark.parametrize("key", list(SPECS), ids=lambda k: "-".join(k))
@pytest.mark.parametrize("world", WORLDS)
def test_engine_over_ranks_equals_one_process(runs, world, key):
    want, windows, needed = runs["single"][key]
    assert sum(want[0].updates) > 0
    for rank, r in enumerate(runs["ranks"][world]):
        got, got_windows, got_needed = r["results"][key]
        assert (got_windows, got_needed) == (windows, needed), rank
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"rank {rank} replicate {i}")
        stats = r["stats"][key]
        assert stats["hops"] > 0 and stats["hop_bytes"] > 0, stats
        assert stats["all_gathers"] > 0 and stats["all_reduces"] > 0, stats


def test_two_ranks_equal_the_reference_sharded_engine(runs):
    got = runs["ranks"][2][0]["results"][REFERENCE_CASE][0][0]
    sig = json.loads(json.dumps(qos_signature(got)))
    want = runs["reference"]
    assert sum(sig["updates"]) > 0
    assert sig == want, sorted(k for k in want if sig.get(k) != want[k])


REFUSALS = {
    "nccl_more_ranks_than_cards": ("RuntimeError", "one rank on each card"),
    "shards_not_a_multiple_of_ranks": ("ValueError", "do not split evenly"),
    "backend_not_the_groups": ("ValueError", "unknown backend"),
    "engine_shards_not_the_groups": ("ValueError", "the rank group splits"),
    "group_without_shards": ("ValueError", "shards > 1"),
    "hop_of_the_wrong_blocks": ("ValueError", "this rank holds"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
@pytest.mark.parametrize("world", WORLDS)
def test_rank_path_refuses(runs, world, case):
    kind, words = REFUSALS[case]
    for r in runs["ranks"][world]:
        got = r["negative"][case]
        assert got is not None, f"{case}: nothing raised"
        assert got[0] == kind and words in got[1], got
