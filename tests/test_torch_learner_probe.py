"""``rnad_tpu_torch.learner_probe`` (tools/learner_probe.py's counterpart)
on the CPU: its configs and labels are the tool's, it runs end to end at
64 lanes and 2 iterations with its self-checks holding, and without a card
it refuses to run unless given ``--cpu``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from rnad_tpu_torch import learner_probe

REPO = pathlib.Path(__file__).resolve().parent.parent
ONLY = "f32/heads,f32/frozen,f32/heads-flat,f32/heads-amb"
KEYS = {"config", "updates_per_s", "ms_per_step", "method", "loss0", "flat",
        "k1_per_step", "k2_per_step", "device", "power_limit_w"}


def _probe(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m",
                           "rnad_tpu_torch.learner_probe", *argv],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(REPO))


def test_configs_are_the_tools():
    labels = [c[0] for c in learner_probe.select(None, None)]
    assert len(labels) == 16 and len(set(labels)) == 16
    assert all(c[-1] == "auto" for c in learner_probe.select(None, None))
    crossed = learner_probe.select("f32/heads$", "scan,associative")
    assert [c[0] for c in crossed] == ["f32/heads@scan",
                                       "f32/heads@associative"]
    cfg, net_cfg = learner_probe.configs(
        ("bf16/heads-amb-flat", "bfloat16", "bfloat16", "heads-amb-flat",
         "scan"), 64, 16, 3)
    assert (cfg.fuse_net_passes, cfg.learner_layout, cfg.flat_optimizer,
            cfg.detailed_metrics, cfg.vtrace_mode) == (
        "heads", "amb", True, True, "scan")
    assert net_cfg.compute_dtype == "bfloat16" and net_cfg.width == 16
    assert learner_probe.off_of(crossed[1])[0] == "f32/off@associative"
    lines = learner_probe.summary({"f32/off": 10.0, "f32/heads": 12.0,
                                   "bf16/heads": 9.0})
    assert lines[1] == "# f32/heads:     12.0/s  (1.200x vs off)"
    assert len(lines) == 2  # no bf16/off: no base


def test_probe_runs_on_the_cpu():
    proc = _probe("--cpu", "--batch", "64", "--iters", "2", "--width", "16",
                  "--only", ONLY)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("tree=306 depth=4 batch=64 device=cpu")
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["config"] for r in rows] == [
        "f32/heads", "f32/frozen", "f32/heads-amb", "f32/heads-amb-flat",
        "f32/heads-flat"]
    for r in rows:
        assert set(r) == KEYS
        assert r["method"] == "back-to-back" and r["device"] == "cpu"
        assert r["updates_per_s"] > 0 and r["flat"] == ("flat" in r["config"])
        # the same state and noise: every loss within rtol 1e-5 of "off"
        assert r["loss0"] == pytest.approx(rows[0]["loss0"], rel=1e-5)
    # kernels launch on the card only
    assert all(r["k1_per_step"] == r["k2_per_step"] == 0 for r in rows)
    assert [x for x in lines if x.startswith("#")] == []  # no f32/off row


def test_self_check_raises():
    """A first step's loss away from the "off" config's fails the row."""
    tree_lib = learner_probe.tree_lib
    tree = tree_lib.generate_tree(learner_probe.bench.TREE_CONFIG, seed=0,
                                  device="cpu")
    packed = learner_probe.stepping.make_packed_tables(tree)
    combo = learner_probe.select("f32/heads$", None)[0]
    with pytest.raises(AssertionError, match="within rtol"):
        learner_probe.measure(combo, tree, packed, 32, 16, 1, 1e9,
                              {"device": "cpu", "power_limit_w": None})


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        learner_probe.main(["--batch", "64", "--iters", "2"])
    assert exit_.value.code not in (0, None)
    assert "--cpu" in str(exit_.value.code)
    assert capsys.readouterr().out == ""
