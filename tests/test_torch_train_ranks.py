"""Training's pod axis over ``torch.distributed`` ranks.

Two and four gloo ranks on the CPU (``rank_cases``, spawned once per rank
count) against one process at the same ``n_pods``, bitwise:

* the reduced qwen2-1.5b and qwen3-0.6b, float32, 3 steps of
  ``make_train_step`` from the seed-0 state, at 2 ranks x 1 pod, 2 ranks x
  2 pods and 4 ranks x 1 pod, in modes 0-4 (modes 1/2 with an outer sync
  on step 2) and mode 3 with the int8 and the top-k compressor: every
  state leaf (the ranks' pods put back in order) and every metric, on
  every rank; and the all-gathers each step issued, which are every
  cross-pod reduction of the mode;
* 2 ranks at ``n_pods`` = 4 in mode 3 int8 held to the reference's jitted
  ``make_train_step`` from the same state, at ``test_torch_train.py``'s
  tolerances (loss 1e-5 relative, grad norm 1e-4, parameters within 5% of
  the steps' learning-rate sum);
* checkpoints cross between 1 and 2 ranks: 2 ranks write the files one
  process writes (every array and the manifest), one process restores
  them and continues as the uninterrupted run does, and 2 ranks restore a
  one-process checkpoint and continue likewise;
* the refusals: pods that do not split over the ranks, NCCL with more
  ranks than cards, a backend that is not the group's, a state, step or
  batch of another pod count.

Then the CLI: launched as 2 gloo ranks (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` as ``torch.distributed.run`` sets them, ``--dist-init
file://...``) it prints on rank 0 the history one process prints, nothing
on rank 1, and its checkpoint is the one process's; restarted from its
step-2 checkpoint it ends where the uninterrupted run ended.  Under ranks
it refuses a run without ``--dist-backend``, pods that do not split and
NCCL with more ranks than cards, before joining; without ranks it refuses
the rank flags.
"""
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.pytree import flatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, NORM_RTOL, MOVE_TOL = 1e-5, 1e-4, 0.05

#: {ranks: [(arch, mode, compressor, pods a rank)]}
CASES = {w: [(arch, mode, comp, per) for (ws, per) in rank_cases.TRAIN_LAYOUTS
             if ws == w for arch in rank_cases.TRAIN_ARCHS
             for mode, comp in rank_cases.TRAIN_MODES] for w in (2, 4)}
#: the case held to the reference too: 2 ranks x 2 pods
REF_CASE = ("qwen3-0.6b", 3, "int8", 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ranks")
    one = str(tmp / "one")
    first = rank_cases.ckpt_run(one, 2, 2)      # the ranks restore this
    restored = str(tmp / "restored")
    shutil.copytree(one, restored)
    written = str(tmp / "written")
    spawned = {w: rank_cases.start(
        w, tmp, "train_cases",
        {"cases": CASES[w], "ckpt": (written, restored) if w == 2 else None})
        for w in CASES}
    single = {}
    for w, cases in CASES.items():
        for arch, mode, comp, per in cases:
            key = (arch, mode, comp, w * per)
            if key not in single:
                single[key] = rank_cases.train_result(*key)
    # the uninterrupted one-process run: step 3 after the step-2 checkpoint
    uninterrupted = rank_cases.ckpt_run(one, 3, 1)
    return dict(ranks={w: r.results() for w, r in spawned.items()},
                single=single, one=one, written=written, restored=restored,
                first=first, uninterrupted=uninterrupted)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_state_bits(want, parts, label):
    """The ranks' states, their pods put back in order, are ``want``
    bitwise; the step counter is whole on every rank."""
    want = flatten(want)
    parts = [flatten(p) for p in parts]
    assert all(sorted(p) == sorted(want) for p in parts), label
    for k, v in want.items():
        got = ([p[k] for p in parts] if k == "step" else
               [torch.cat([p[k] for p in parts])])
        for g in got:
            assert g.dtype == v.dtype and g.shape == v.shape, (label, k)
            assert torch.equal(bits(g), bits(v)), (label, k)


def assert_metrics_bits(want, got, label):
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        assert sorted(w) == sorted(g), label
        for k in w:
            a, b = w[k], g[k]
            if isinstance(a, torch.Tensor):
                a, b = bits(a), bits(b)
                assert a.dtype == b.dtype and torch.equal(a, b), (label, i, k)
            else:
                assert type(a) is type(b) and a == b, (label, i, k)


@pytest.mark.parametrize("case", [(w, *c) for w in CASES for c in CASES[w]],
                         ids=lambda c: "{}ranks-{}-mode{}-{}-{}pods".format(
                             c[0], c[1], c[2], c[3] or "plain", c[4]))
def test_train_over_ranks_equals_one_process(runs, case):
    world, arch, mode, comp, per = case
    state, metrics = runs["single"][(arch, mode, comp, world * per)]
    got = [r["results"][(arch, mode, comp, per)]
           for r in runs["ranks"][world]]
    assert_state_bits(state, [g[0] for g in got], case)
    for g in got:                       # every rank, the same metrics
        assert_metrics_bits(metrics, g[1], case)


def gathers_a_step(mode, comp, leaves, step):
    """The all-gathers a step issues: the mode's cross-pod reductions (one
    a leaf; a compressed leaf gathers its two payload tensors; modes 1/2
    only on the sync step, the second of each period of 2) and the three
    metrics' means."""
    per_leaf = {0: 1, 3: 2 if comp else 1, 4: 0}.get(mode, step % 2)
    return per_leaf * leaves + 3


@pytest.mark.parametrize("world", sorted(CASES))
def test_every_cross_pod_reduction_is_an_all_gather(runs, world):
    """Each case's all-gathers are the reductions its mode makes; mode 4
    moves only its metrics (three float32 numbers a pod a step)."""
    for r in runs["ranks"][world]:
        for arch, mode, comp, per in CASES[world]:
            st = r["stats"][(arch, mode, comp, per)]
            leaves = len(r["results"][(arch, mode, comp, per)][0]["params"])
            want = sum(gathers_a_step(mode, comp, leaves, s)
                       for s in range(rank_cases.TRAIN_STEPS))
            assert st["all_gathers"] == want, (arch, mode, comp, st)
            assert st["hops"] == st["all_reduces"] == 0
            if mode == 4:
                assert st["all_gather_bytes"] == \
                    3 * 4 * per * rank_cases.TRAIN_STEPS
            assert st["all_gather_s"] > 0


def test_two_ranks_at_four_pods_match_the_reference(runs):
    pytest.importorskip("jax")
    import jax

    from repro.configs import get_config
    from repro.configs.smoke import reduce_for_smoke
    from repro.core.modes import AsyncMode
    from repro.launch import train as ref_train
    from repro.optim.adamw import AdamWConfig
    from repro.optim.outer import OuterConfig
    arch, mode, comp, per = REF_CASE
    n_pods = 2 * per
    spec = ref_train.TrainSpec(
        mode=AsyncMode(mode), compressor=comp,
        adamw=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        outer=OuterConfig(sync_period=2))
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    step = jax.jit(ref_train.make_train_step(cfg, spec, n_pods))
    ref_state = interop.train_state_to_numpy(train.init_train_state(
        rank_cases.train_cfg(arch), rank_cases.train_spec(mode, comp),
        n_pods, device="cpu"))
    got = [r["results"][REF_CASE] for r in runs["ranks"][2]]
    lr_sum = 0.0
    for b, m in zip(rank_cases.train_batches(rank_cases.train_cfg(arch),
                                             n_pods), got[0][1]):
        ref_state, want = step(ref_state, {k: v.numpy()
                                           for k, v in b.items()})
        lr_sum += float(want["lr"])
        assert abs(float(m["loss"]) / float(want["loss"]) - 1) <= LOSS_RTOL
        assert abs(float(m["grad_norm"]) / float(want["grad_norm"])
                   - 1) <= NORM_RTOL
        assert float(m["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    want = flatten(jax.tree.map(np.asarray, ref_state))
    for k in flatten(got[0][0]):
        if k.startswith("params/"):
            whole = torch.cat([flatten(g[0])[k] for g in got]).double()
            err = float((whole - torch.as_tensor(want[k]).double())
                        .abs().max())
            assert err <= MOVE_TOL * lr_sum, (k, err, lr_sum)


# ---------------------------------------------------------------------------
# checkpoints across rank counts
# ---------------------------------------------------------------------------
def checkpoint_contents(ckpt_dir, step):
    """A checkpoint's manifest and every array's raw bytes, in file order
    (the zip's own timestamps aside)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        arrays = [(n, z.read(n)) for n in z.namelist()]
    return manifest, arrays


def losses(history):
    return [(h["step"], h["loss"], h["grad_norm"]) for h in history]


def test_ranks_write_the_one_process_checkpoint_and_one_process_restores_it(
        runs, tmp_path):
    rank0 = runs["ranks"][2][0]["ckpt"]
    assert checkpoint_contents(runs["written"], 2) == \
        checkpoint_contents(runs["one"], 2)
    # one process continues from the ranks' checkpoint
    d = str(tmp_path / "continued")
    shutil.copytree(runs["written"], d)
    logs = []
    history = rank_cases.ckpt_run(d, 3, 1, log=logs.append)
    assert logs[0] == "[train] restored checkpoint at step 2"
    assert losses(history) == losses(runs["uninterrupted"][-1:])
    assert losses(rank0["written"]) == losses(runs["first"])
    assert checkpoint_contents(d, 3) == checkpoint_contents(runs["one"], 3)


def test_ranks_restore_a_one_process_checkpoint(runs):
    for r in runs["ranks"][2]:
        assert losses(r["ckpt"]["restored"]) == \
            losses(runs["uninterrupted"][-1:])
    assert runs["ranks"][2][0]["ckpt"]["logs"][0] == \
        "[train] restored checkpoint at step 2"
    assert runs["ranks"][2][1]["ckpt"]["logs"] == []     # rank 0 logs
    assert checkpoint_contents(runs["restored"], 3) == \
        checkpoint_contents(runs["one"], 3)


NEGATIVE = {
    "pods_not_a_multiple_of_ranks": ("ValueError", "do not split evenly"),
    "nccl_more_ranks_than_cards": ("RuntimeError", "one rank on each card"),
    "backend_not_the_groups": ("ValueError", "the process group runs"),
    "state_of_other_pods": ("ValueError", "but n_pods is"),
    "step_of_other_pods": ("ValueError", "but n_pods is"),
    "batch_of_other_pods": ("ValueError", "the batch holds"),
}


@pytest.mark.parametrize("name", sorted(NEGATIVE))
@pytest.mark.parametrize("world", sorted(CASES))
def test_refusals_over_ranks(runs, world, name):
    kind, words = NEGATIVE[name]
    for r in runs["ranks"][world]:
        got = r["negative"][name]
        assert got is not None and got[0] == kind and words in got[1], got


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--arch", "qwen3-0.6b-smoke", "--batch", "4",
       "--seq", "32", "--steps", "4", "--n-pods", "2", "--mode", "3",
       "--compressor", "int8", "--log-every", "1", "--ckpt-every", "2"]


def history_lines(text):
    """The header and the step lines, without their wall times."""
    return [x.rsplit(" ", 2)[0] if "ms/step" in x else x
            for x in text.splitlines()
            if x.startswith("[train]") and "done" not in x
            and "ranks" not in x]


def cli_ranks(tmp_path, ckpt_dir, tag):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    store = tmp_path / f"store-{tag}"
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", ckpt_dir, "--dist-backend", "gloo", "--dist-init",
         f"file://{store}"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]


def outputs(procs):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=rank_cases.TIMEOUT)
        assert p.returncode == 0, err
        outs.append(out)
    return outs


def test_cli_over_two_gloo_ranks_prints_the_one_process_history_and_restarts(
        tmp_path, capsys):
    ranked, single = str(tmp_path / "ranks"), str(tmp_path / "one")
    procs = cli_ranks(tmp_path, ranked, "first")
    train.main(CLI + ["--ckpt-dir", single])
    want = capsys.readouterr().out
    outs = outputs(procs)
    assert history_lines(outs[0]) == history_lines(want)
    assert len(history_lines(want)) == 5 and outs[1] == ""
    assert "2 gloo ranks, 1 pod(s) a rank" in outs[0]
    for step in (2, 4):
        assert checkpoint_contents(ranked, step) == \
            checkpoint_contents(single, step)
    # a restart from the step-2 checkpoint ends where the run ended
    uninterrupted = checkpoint_contents(ranked, 4)
    shutil.rmtree(os.path.join(ranked, "step_00000004"))
    outs = outputs(cli_ranks(tmp_path, ranked, "restart"))
    lines = history_lines(outs[0])
    assert "[train] restored checkpoint at step 2" in lines
    assert lines[-2:] == history_lines(want)[-2:]
    assert checkpoint_contents(ranked, 4) == uninterrupted


@pytest.mark.parametrize("env, argv, words", [
    ({}, ["--dist-backend", "gloo"], "launch through python -m"),
    ({}, ["--dist-init", "file:///nowhere"], "launch through python -m"),
    ({"WORLD_SIZE": "2"}, [], "pass --dist-backend"),
    ({"WORLD_SIZE": "2"}, ["--dist-backend", "gloo", "--n-pods", "3",
                           "--batch", "3"], "must split over the 2 ranks"),
    ({"WORLD_SIZE": "2"}, ["--dist-backend", "nccl"],
     "one rank on each card"),
], ids=["backend-without-ranks", "init-without-ranks", "ranks-without-backend",
        "pods-do-not-split", "nccl-more-ranks-than-cards"])
def test_cli_refuses_before_joining(monkeypatch, capsys, env, argv, words):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--arch", "qwen3-0.6b-smoke",
                    "--n-pods", "2", "--steps", "1"] + argv)
    assert e.value.code == 2 and words in capsys.readouterr().err
