"""The port's train CLI (``python -m rnad_tpu_torch.train``): a run on the
CPU, its resume, the option strings of ``examples/train.py``, the options
whose values the port does not run, and the flag sets of the round-5
buffered and noisy-lift runs (docs/CONVERGENCE.md) at a small size."""

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu_torch import train
from rnad_tpu_torch.parallel import runtime

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--cpu", "--demo", "--tree-depth", "3", "--batch-size", "64",
        "--max-updates", "1", "--checkpoint-mod", "50", "--name", "cli"]


def _cli(cwd):
    # one thread: the test shares the machine with other test workers
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "rnad_tpu_torch.train",
                          *ARGS], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    final = re.findall(r"final nashconv: (\S+)", out.stderr)
    assert len(final) == 1 and math.isfinite(float(final[0]))
    return out.stderr


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("cli")
    return cwd, _cli(cwd)


def test_cli_trains_and_writes_the_run(first_run):
    cwd, log = first_run
    run = cwd / "saved_runs" / "cli"
    params = json.loads((run / "params.json").read_text())
    assert params["rnad"]["batch_size"] == 512  # --demo's, as examples/
    assert sorted(p.name for p in (run / "0").iterdir()) == ["0.ckpt",
                                                            "50.ckpt"]
    lines = [json.loads(x) for x in (run / "metrics.jsonl").open()]
    assert [r["step"] for r in lines] == [1, 21, 41, 61, 81, 100]
    assert (run / "best.ckpt").exists()
    assert (cwd / "saved_trees" / "cli" / "tree.npz").exists()
    assert "tree: size=" in log and "initializing R-NaD run cli" in log


def test_cli_resumes(first_run):
    cwd, _ = first_run
    log = _cli(cwd)
    assert "resumed run cli at m=0 n=50" in log
    lines = [json.loads(x) for x in
             (cwd / "saved_runs" / "cli" / "metrics.jsonl").open()]
    # the resumed run logs its steps 51..100 (n = 60, 80) and a final eval
    assert [r["step"] for r in lines[6:]] == [61, 81, 100]


def _option_strings(source):
    tree = ast.parse(source)
    return {arg.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for arg in node.args
            if isinstance(arg, ast.Constant) and str(arg.value).startswith("-")}


def test_parser_has_every_option_of_examples_train():
    want = _option_strings((REPO / "examples" / "train.py").read_text())
    got = {s for a in train.build_parser()._actions for s in a.option_strings
           if s not in ("-h", "--help")}
    assert len(want) > 40 and got == want


DP_ARGS = ["--cpu", "--demo", "--tree-depth", "3", "--max-updates", "1",
           "--name", "dp"]


def test_data_parallel_one_rank_equals_the_plain_run(tmp_path, monkeypatch):
    """``--data-parallel`` alone is a one-rank gloo world: the all-reduces
    over one rank change nothing, so the run ends on the plain run's
    weights bitwise, with a finite final NashConv."""
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test shares the machine with others
    try:
        for flag in ([], ["--data-parallel"]):
            cwd = tmp_path / ("dp" if flag else "plain")
            cwd.mkdir()
            monkeypatch.chdir(cwd)
            runs[bool(flag)] = train.main(DP_ARGS + flag)
    finally:
        torch.set_num_threads(threads)
    dp, plain = runs[True], runs[False]
    assert dp.group is not None and dp.group.world == 1
    assert plain.group is None
    assert dp.state.total_steps == plain.state.total_steps == 100
    for (name, a), b in zip(dp.state.net.state_dict().items(),
                            plain.state.net.state_dict().values()):
        assert torch.equal(a, b), name
    values = [m["nashconv"] for _, m in dp.history if "nashconv" in m]
    assert math.isfinite(values[-1])
    assert values == [m["nashconv"] for _, m in plain.history
                      if "nashconv" in m]


def _ranks(tmp_path, argv):
    """Two CLI processes ``argv``, ranks 0 and 1 of one gloo group, each in
    its own working directory; returns their (returncode, stderr)."""
    port = str(runtime.free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for rank in (0, 1):
        (tmp_path / f"rank{rank}").mkdir()
        with open(tmp_path / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rnad_tpu_torch.train", *argv,
                 "--coordinator", f"localhost:{port}", "--num-processes",
                 "2", "--process-id", str(rank)], cwd=tmp_path / f"rank{rank}",
                env=env, stdout=subprocess.DEVNULL, stderr=log))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, (tmp_path / f"rank{r}.log").read_text())
            for r, p in enumerate(procs)]


def test_two_process_cli_run(tmp_path):
    """``--coordinator --num-processes 2 --process-id {0,1}`` on the CPU:
    both ranks end with the same finite final NashConv; only rank 0 writes
    the tree and the run store."""
    (rc0, log0), (rc1, log1) = _ranks(tmp_path, DP_ARGS[:-1] + ["mp"])
    assert rc0 == 0 and rc1 == 0, log0[-3000:] + log1[-3000:]
    final = [re.findall(r"final nashconv: (\S+)", log) for log in (log0,
                                                                   log1)]
    assert len(final[0]) == 1 and final[0] == final[1]
    assert math.isfinite(float(final[0][0]))
    assert "data-parallel: rank 0/2 on cpu over gloo" in log0
    assert "data-parallel: rank 1/2 on cpu over gloo" in log1
    run = tmp_path / "rank0" / "saved_runs" / "mp"
    assert (run / "params.json").exists() and (run / "best.ckpt").exists()
    assert (tmp_path / "rank0" / "saved_trees" / "mp").exists()
    assert not any((tmp_path / "rank1").iterdir())  # rank 1 wrote nothing


def test_batch_that_does_not_divide_raises(tmp_path):
    """A batch the ranks cannot split raises on both ranks before anything
    is written."""
    results = _ranks(tmp_path, ["--cpu", "--tree-depth", "3",
                                "--batch-size", "63", "--name", "odd"])
    for rc, log in results:
        assert rc != 0 and "must divide over 2" in log, log[-3000:]
    assert not any((tmp_path / "rank0").iterdir())
    assert not any((tmp_path / "rank1").iterdir())


@pytest.mark.parametrize("argv", [
    ["--frozen-dtype", "bfloat16"],
    ["--net-depth", "3", "--width", "16"],
    ["--net", "ConvNet", "--channels", "4", "--compute-dtype", "bfloat16"],
    ["--vtrace-mode", "associative"],
])
def test_formerly_unported_options_run(tmp_path, monkeypatch, argv):
    """The bfloat16 frozen passes, the deep MLP, the bfloat16 ConvNet and
    the associative v-trace run one update on the CPU and reach the
    trainer's configs."""
    monkeypatch.chdir(tmp_path)
    run = train.main(["--cpu", "--tree-depth", "2", "--batch-size", "16",
                      "--bounds", "1", "--delta-m", "2", "--name", "x",
                      *argv])
    assert run.state.total_steps == 2
    assert all(math.isfinite(v) for _, m in run.history for v in m.values())
    if "--frozen-dtype" in argv:
        assert run.cfg.frozen_net_dtype == "bfloat16"
    if "--net-depth" in argv:
        assert run.state.net.depth == 3 and hasattr(run.state.net,
                                                    "value_hidden2")
    if "--compute-dtype" in argv:
        assert run.net_config.type == "ConvNet"
        assert str(run.state.net.dtype) == "torch.bfloat16"
    if "--vtrace-mode" in argv:
        assert run.cfg.vtrace_mode == "associative"


def test_tpu_layout_options_change_nothing(tmp_path, monkeypatch):
    """--learner-layout bma and --flat-optimizer are accepted and change
    no weight; rnad_tpu's batch-minor "amb" is refused before the first
    step; the schedule flags reach the trainer's config."""
    monkeypatch.chdir(tmp_path)
    common = ["--cpu", "--tree-depth", "2", "--batch-size", "16",
              "--bounds", "1", "--delta-m", "2", "--lr-schedule", "cosine",
              "--lr-decay-steps", "1", "--reg-anchor", "best"]
    plain = train.main(common + ["--name", "plain"])
    laid = train.main(common + ["--name", "laid", "--learner-layout", "bma",
                                "--flat-optimizer"])
    assert laid.cfg.learner_layout == "bma" and laid.cfg.flat_optimizer
    with pytest.raises(SystemExit) as refused:
        train.main(common + ["--name", "amb", "--learner-layout", "amb"])
    assert refused.value.code == 2  # argparse's: an invalid choice
    assert not (tmp_path / "saved_runs" / "amb").exists()
    assert plain.cfg.reg_anchor == "best" and plain.cfg.lr_decay_steps == 1
    for p, q in zip(plain.state.net.parameters(), laid.state.net.parameters()):
        assert (p == q).all()


# r5-offpol-32k's buffer flags, r5-noisy-conv's and r5-noisy-mlp's lift and
# nets, each on a depth-3 tree at 64 lanes
SMALL = ["--cpu", "--tree-depth", "3", "--batch-size", "64", "--bounds", "2",
         "--delta-m", "4", "--checkpoint-mod", "2", "--log-mod", "1"]
ROUND5 = {
    "offpol": ["--n-batches-per-buffer", "4", "--buffer-mod", "2"],
    "noisy-conv": ["--obs-lift", "8", "--obs-noise-sigma", "0.15", "--net",
                   "ConvNet", "--channels", "8", "--net-depth", "2"],
    "noisy-mlp": ["--obs-lift", "8", "--obs-noise-sigma", "0.15",
                  "--width", "32"],
}


@pytest.fixture(scope="module")
def rnad_tpu_metric_keys(tmp_path_factory):
    """The keys of rnad_tpu's metrics.jsonl lines on its buffered path."""
    root = tmp_path_factory.mktemp("jax")
    from rnad_tpu.config import TreeConfig
    from rnad_tpu.env import tree as tree_lib

    tree = tree_lib.generate_tree(TreeConfig(
        max_actions=3, max_transitions=2, transition_threshold=0.3,
        depth_bound=3), seed=0)
    run = jax_rnad.RNaD(tree, RNaDConfig(batch_size=32, bounds=(1,),
                                         delta_m=(2,), n_batches_per_buffer=4,
                                         buffer_mod=2),
                        NetConfig(max_actions=3, width=16),
                        directory_name="jax", runs_root=str(root))
    run.run(log_mod=1)
    run.final_eval()
    run.logger.finish()
    lines = (root / "jax" / "metrics.jsonl").read_text().splitlines()
    return [sorted(json.loads(x)) for x in lines]


@pytest.mark.parametrize("name", sorted(ROUND5))
def test_cli_runs_the_round5_flag_sets(tmp_path, monkeypatch, name,
                                       rnad_tpu_metric_keys):
    monkeypatch.chdir(tmp_path)
    argv = SMALL + ROUND5[name] + ["--name", name]
    first = train.main(argv + ["--max-updates", "1"])
    cfg, net_cfg = first.cfg, first.net_config
    assert (cfg.n_batches_per_buffer, cfg.buffer_mod) == (
        (4, 2) if name == "offpol" else (1, 1))
    if name != "offpol":
        assert cfg.obs_transform.kind == "lift"
        assert (cfg.obs_transform.channels, cfg.obs_transform.sigma) == (
            8, 0.15)
        assert net_cfg.type == ("ConvNet" if name == "noisy-conv" else "MLP")
        assert net_cfg.batch_norm  # as examples/train.py leaves it
    assert first.state.total_steps == 4
    assert first.store.latest() == (0, 2)
    again = train.main(argv)  # resumes at (0, 2): steps 3..8
    assert again.state.total_steps == 8
    assert [s for s, m in again.history if "loss" in m] == list(range(3, 9))
    lines = [json.loads(x) for x in
             (tmp_path / "saved_runs" / name / "metrics.jsonl").open()]
    assert all(math.isfinite(v) for r in lines for v in r.values())
    keys = {tuple(sorted(r)) for r in lines}
    assert keys == {tuple(k) for k in rnad_tpu_metric_keys}
