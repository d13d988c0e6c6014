"""The port's train CLI (``python -m rnad_tpu_torch.train``): a run on the
CPU, its resume, the option strings of ``examples/train.py`` and the options
whose values the port does not run."""

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

from rnad_tpu_torch import train

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


@pytest.mark.parametrize("argv,flag", [
    (["--data-parallel"], "--data-parallel"),
    (["--coordinator", "localhost:1234"], "--coordinator"),
    (["--num-processes", "2"], "--num-processes"),
    (["--process-id", "0"], "--process-id"),
    (["--obs-lift", "8"], "--obs-lift"),
    (["--n-batches-per-buffer", "4"], "--n-batches-per-buffer"),
    (["--buffer-mod", "2"], "--buffer-mod"),
    (["--frozen-dtype", "bfloat16"], "--frozen-dtype"),
    (["--net", "ConvNet"], "--net"),
    (["--net-depth", "3"], "--net-depth"),
    (["--vtrace-mode", "associative"], "--vtrace-mode"),
])
def test_unported_options_raise(tmp_path, monkeypatch, argv, flag):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=flag):
        train.main(["--cpu", *argv])
    assert not any(tmp_path.iterdir())  # raised before any work


def test_tpu_layout_options_change_nothing(tmp_path, monkeypatch):
    """--learner-layout and --flat-optimizer are accepted; the schedule
    flags reach the trainer's config."""
    monkeypatch.chdir(tmp_path)
    common = ["--cpu", "--tree-depth", "2", "--batch-size", "16",
              "--bounds", "1", "--delta-m", "2", "--lr-schedule", "cosine",
              "--lr-decay-steps", "1", "--reg-anchor", "best"]
    plain = train.main(common + ["--name", "plain"])
    laid = train.main(common + ["--name", "laid", "--learner-layout", "amb",
                                "--flat-optimizer"])
    assert laid.cfg.learner_layout == "amb" and laid.cfg.flat_optimizer
    assert plain.cfg.reg_anchor == "best" and plain.cfg.lr_decay_steps == 1
    for p, q in zip(plain.state.net.parameters(), laid.state.net.parameters()):
        assert (p == q).all()
