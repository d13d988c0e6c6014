"""``rnad_tpu_torch.rollout_probe`` (tools/rollout_probe.py's counterpart)
on the CPU: its variant grammar is the tool's, it runs end to end at 64
lanes and 2 iterations with its self-checks holding, prints a row a
variant and the ratios to ``base``, and without a card it refuses to run
unless given ``--cpu``."""

import json
import re

import pytest
import torch

from rnad_tpu_torch import bench, rollout_probe

KEYS = {"variant", "half_steps_per_s", "dt_s", "mean_return", "lane_chunks",
        "policy_minor", "k1_per_rollout", "k2_per_rollout", "peak_mem_gib",
        "device", "power_limit_w"}


@pytest.mark.parametrize("name,want", [
    ("base", (False, False, 1)), ("fused", (True, False, 1)),
    ("fused_pmin", (True, True, 1)), ("base_pmin", (False, True, 1)),
    ("chunk2", (False, False, 2)), ("fused_chunk4", (True, False, 4)),
    ("fused_pmin_chunk8", (True, True, 8)),
    ("base_chunk3", (False, False, 3))])
def test_variants_are_the_tools_grammar(name, want):
    assert rollout_probe.parse(name) == want
    # the tool's pattern (inside its main) and its defaults
    assert re.fullmatch(
        r"(base|fused)(_pmin)?(?:_chunk(\d+))?|chunk(\d+)", name)
    assert (rollout_probe.BATCH, rollout_probe.ITERS) == (1 << 17, 256)


def test_probe_runs_on_the_cpu(capsys):
    variants = ["base", "fused", "fused_pmin", "chunk2", "fused_chunk4"]
    rows = rollout_probe.main(["--cpu", "--batch", "64", "--iters", "2",
                               "--variants", ",".join(variants)])
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in out if x.startswith("{")] == rows
    assert [r["variant"] for r in rows] == variants
    for r in rows:
        assert set(r) == KEYS
        assert (r["device"], r["power_limit_w"], r["peak_mem_gib"]) == (
            "cpu", None, None)
        assert r["half_steps_per_s"] > 0 and abs(r["mean_return"]) <= 1
        # kernels launch on the card only
        assert r["k1_per_rollout"] == r["k2_per_rollout"] == 0
        fused, pmin, chunks = rollout_probe.parse(r["variant"])
        assert (r["policy_minor"], r["lane_chunks"]) == (pmin, chunks)
    # the same noise a variant: the record's layout changes no episode
    assert rows[1]["mean_return"] == rows[2]["mean_return"]
    ratios = [x for x in out if x.startswith("#")]
    assert len(ratios) == len(variants) - 1
    assert ratios[0].startswith("# fused: ") and ratios[0].endswith("x base")
    assert rollout_probe.ratios({"fused": 2.0}) == []


def test_lane_collapse_raises(monkeypatch):
    """Lanes that all play one episode fail the diversity check."""
    real = bench.rollout_fn

    def collapsed(*args, **kw):
        roll = real(*args, **kw)

        def one_episode():
            traj = roll()
            traj.rewards = torch.zeros_like(traj.rewards)
            traj.rewards[1] = 0.5
            return traj
        return one_episode

    monkeypatch.setattr(bench, "rollout_fn", collapsed)
    with pytest.raises(AssertionError, match="lane collapse"):
        rollout_probe.main(["--cpu", "--batch", "16", "--iters", "1",
                            "--variants", "fused"])


def test_garbage_is_flagged(monkeypatch, capsys):
    """A mean return outside [-1, 1] is flagged on a # line and the row
    still printed, as the tool does."""
    real = bench.rollout_fn

    def garbage(*args, **kw):
        roll = real(*args, **kw)

        def shifted():
            traj = roll()
            traj.rewards = traj.rewards + 3.0
            return traj
        return shifted

    monkeypatch.setattr(bench, "rollout_fn", garbage)
    rows = rollout_probe.main(["--cpu", "--batch", "16", "--iters", "1",
                               "--variants", "base"])
    out = capsys.readouterr().out
    assert "# base: COMPUTED GARBAGE" in out
    assert rows[0]["mean_return"] > 1


@pytest.mark.parametrize("argv,match", [
    (["--variants", "base,turbo"], "unknown variant turbo"),
    (["--variants", "chunk3", "--batch", "64"], "do not split into 3"),
    (["--variants", "fused_chunk0"], "do not split into 0")])
def test_refuses_bad_variants(argv, match):
    with pytest.raises(ValueError, match=match):
        rollout_probe.main(["--cpu", *argv])


def test_refuses_without_a_card_unless_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match="pass --cpu"):
        rollout_probe.main(["--batch", "16", "--iters", "1"])
