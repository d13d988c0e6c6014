"""rnad_tpu_torch.distill_floor against tools/distill_floor.py.

- ``parse_net`` gives the same NetConfig for every spec form;
- on the CPU, on a tree both packages load from one tree store, the two
  CLIs print the same JSON keys, line by line;
- the net-free RM+ skyline's NashConv agrees with rnad_tpu's within 1e-5
  (float32 RM+ summed in another order parts on a few games).
"""

import importlib.util
import json
import pathlib
import sys

import pytest

from rnad_tpu.utils import checkpoint as jax_checkpoint
from rnad_tpu_torch import distill_floor

REPO = pathlib.Path(__file__).resolve().parent.parent
SPECS = ["MLP", "MLP:64", "MLP:512x3", "ConvNet", "ConvNet:24x2",
         "EquiNet", "EquiNet:64x2", "EquiNet:64x2s128", "EquiNet:64x2s128p",
         "EquiNet:128x4s32p"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "distill_floor_tool", REPO / "tools" / "distill_floor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spec", SPECS)
def test_parse_net_matches(spec):
    want = _tool().parse_net(spec, 5)
    got = distill_floor.parse_net(spec, 5)
    assert got.to_json() == want.to_json()


def test_parse_net_rejects_unknown_specs():
    with pytest.raises(SystemExit, match="unknown net spec"):
        distill_floor.parse_net("ResNet:4", 3)


@pytest.fixture
def stored_tree(small_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jax_checkpoint.save_tree(small_tree, "small")
    return "small"


def _jax_lines(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["distill_floor.py", *argv])
    _tool().main()
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_cli_prints_the_same_keys(stored_tree, capsys, monkeypatch):
    argv = ["--cpu", "--tree", stored_tree, "--net", "MLP:16", "--net",
            "EquiNet:4x1s4p", "--net", "RM+:20", "--steps", "3",
            "--node-batch", "64"]
    want = _jax_lines(argv, capsys, monkeypatch)
    got = distill_floor.main(argv)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == got
    assert [sorted(line) for line in got] == [sorted(line) for line in want]
    assert got[0] == want[0]
    for g in got[1:]:
        assert g["floor_nashconv"] >= 0.0


def test_rmplus_skyline_matches(stored_tree, capsys, monkeypatch):
    argv = ["--cpu", "--tree", stored_tree, "--net", "RM+:300"]
    want = _jax_lines(argv, capsys, monkeypatch)[1]
    got = distill_floor.main(argv)[1]
    assert got["iters"] == want["iters"] == 300
    assert abs(got["floor_nashconv"] - want["floor_nashconv"]) <= 1e-5
