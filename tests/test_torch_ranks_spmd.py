"""The SPMD tools and the experiments CLI over ``torch.distributed`` ranks.

Two and four gloo ranks on the CPU (``rank_cases``, spawned once per rank
count) against one process, bitwise:

* ``conduit.ring_exchange`` along dimension 0 (4 blocks) and 1 (8
  blocks), shifts +-1, 3 and -3;
* ``collectives.cross_pod_sum`` over 4 pods split over the ranks, plain
  and through the int8 and top-k compressors (their plain versions on the
  CPU), from given residuals (written in place) and from zero ones;
  ``exchange_gradients`` in modes 0-4 over two steps (mode 3 also with
  each compressor), ``pod_mean`` and ``maybe_param_sync`` on and off;
* graph coloring's ``spmd_step`` on a (4, 2) mesh of 8 x 8 blocks, the
  mesh rows split over the ranks, 20 steps in modes 3, 0, 1 (flush every
  4 steps) and 4: colors, probabilities, conduit buffers, step and every
  step's conflicts.

Then the CLI: ``--family modes`` at ``--shards 8`` launched as 2 gloo
ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` as ``torch.distributed.run``
sets them, ``--dist-init file://...``) prints on rank 0 what one process
prints, the wall-time lines aside, and nothing on rank 1; under ranks it
refuses a run without ``--dist-backend`` and NCCL with more ranks than
cards, before joining any group.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch.runtime.experiments import main as cli_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_ranks")
    spawned = {w: rank_cases.start(w, tmp, "spmd_cases") for w in WORLDS}
    inputs = rank_cases.collective_inputs()
    single = dict(collectives=rank_cases.collective_results(inputs),
                  spmd=rank_cases.spmd_results())
    return dict(ranks={w: r.results() for w, r in spawned.items()},
                single=single)


def leaves(x):
    """The tensors of a result (tuples, lists and dicts of tensors and
    numbers), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in x for t in leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    return [torch.tensor(x)]


def gathered(parts, dim):
    """The ranks' results as one process's: every tensor concatenated
    along the split dimension (the pods, the mesh rows), except where it
    is whole on every rank (0-dim, or expanded over the pods: a total)."""
    out = []
    for ts in zip(*(leaves(p) for p in parts)):
        if ts[0].dim() == 0:
            assert all(torch.equal(t, ts[0]) for t in ts)
            out.append(ts[0])
        else:
            out.append(torch.cat(ts, dim=dim))
    return out


def assert_bits(want, got, label):
    want = leaves(want)
    assert len(want) == len(got), label
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (label, i)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (label, i)


@pytest.mark.parametrize("case", rank_cases.RING_CASES,
                         ids=lambda c: "blocks{}-dim{}-shift{}".format(*c))
@pytest.mark.parametrize("world", WORLDS)
def test_ring_exchange_over_ranks(runs, world, case):
    blocks, dim, shift = case
    x = rank_cases.ring_input(blocks, dim)
    got = torch.cat([r["ring"][case] for r in runs["ranks"][world]], dim)
    assert torch.equal(got, torch.roll(x, shift, dim))


COLLECTIVES = [
    ("cross_pod_sum", "plain"), ("cross_pod_sum", "int8"),
    ("cross_pod_sum", "topk"), ("cross_pod_sum_zero_residuals", "int8"),
    ("cross_pod_sum_zero_residuals", "topk"),
    *[("exchange_gradients", m, "plain") for m in range(5)],
    ("exchange_gradients", 3, "int8"), ("exchange_gradients", 3, "topk"),
    "pod_mean", ("maybe_param_sync", False), ("maybe_param_sync", True)]


@pytest.mark.parametrize("key", COLLECTIVES, ids=str)
@pytest.mark.parametrize("world", WORLDS)
def test_collectives_over_ranks_equal_one_process(runs, world, key):
    want = runs["single"]["collectives"][key]
    got = gathered([r["collectives"][key] for r in runs["ranks"][world]], 0)
    assert_bits(want, got, key)


@pytest.mark.parametrize("mode", [m for m, _ in rank_cases.SPMD_MODES])
@pytest.mark.parametrize("world", WORLDS)
def test_spmd_step_over_ranks_equals_one_process(runs, world, mode):
    state, confs = runs["single"]["spmd"][mode]
    parts = [r["spmd"][mode] for r in runs["ranks"][world]]
    got_state = gathered([p[0] for p in parts], 0)
    assert_bits(state, got_state, mode)
    # conflicts (steps, rows, cols): the rows are split
    got = torch.cat([p[1] for p in parts], dim=1)
    assert torch.equal(got, confs) and int(confs[-1].sum()) >= 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--family", "modes", "--device", "cpu", "--topology", "ring",
       "--procs", "16", "--duration", "0.003", "--shards", "8"]


def report(text):
    """The report without its wall-time lines."""
    return [x for x in text.splitlines() if "wall" not in x]


def test_cli_under_two_gloo_ranks_prints_the_one_process_report(
        tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.runtime.experiments", *CLI,
         "--dist-backend", "gloo", "--dist-init", f"file://{store}"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    cli_main(CLI)
    want = capsys.readouterr().out
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=rank_cases.TIMEOUT)
        assert p.returncode == 0, err
        outs.append(out)
    # the header and one line a mode
    assert report(outs[0]) == report(want) and len(report(want)) == 6
    assert outs[1] == ""


@pytest.mark.parametrize("argv, words", [
    (["--dist-init", "file:///nowhere"], "pass --dist-backend"),
    (["--dist-backend", "nccl"], "one rank on each card"),
])
def test_cli_under_ranks_refuses_before_joining(monkeypatch, capsys, argv,
                                                words):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit) as e:
        cli_main(CLI + argv)
    assert e.value.code == 2 and words in capsys.readouterr().err
