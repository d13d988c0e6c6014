"""The port's eta sweep (``python -m rnad_tpu_torch.eta_sweep``) against
``examples/eta_sweep.py``: the same options, the demo tree with rnad_tpu's
hash saved as ``small_tree``, four runs named ``<prefix>-eta=<eta>`` that
start from the first run's weights, and a sweep on a tree rnad_tpu saved.
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from rnad_tpu.config import ShapingRule, TreeConfig
from rnad_tpu.env import tree as jax_tree_lib
from rnad_tpu.utils import checkpoint as jax_checkpoint
from rnad_tpu_torch import eta_sweep
from rnad_tpu_torch.utils import checkpoint as torch_checkpoint
from tests.test_torch_train_cli import _option_strings

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--cpu", "--bounds", "1", "--delta-m", "2", "--batch-size", "16"]
# examples/eta_sweep.py's tree config, its desc included (the desc is part
# of the config the content hash takes)
JAX_DEMO = TreeConfig(
    max_actions=3, max_transitions=2, transition_threshold=0.3,
    depth_bound=4,
    depth_bound_rule=ShapingRule(delta=-1, stochastic_delta=-2,
                                 stochastic_prob=0.5),
    desc="3x3 stochastic tree, with depth up to 4")


def test_options_and_tree_config_are_examples_eta_sweeps():
    want = _option_strings((REPO / "examples" / "eta_sweep.py").read_text())
    got = {s for a in eta_sweep.build_parser()._actions
           for s in a.option_strings if s not in ("-h", "--help")}
    assert len(want) == 19 and got == want
    defaults = eta_sweep.build_parser().parse_args([])
    assert (defaults.batch_size, defaults.bounds, defaults.delta_m,
            defaults.etas, defaults.lr, defaults.gamma_avg) == (
        512, 64, 100, [0.0, 0.2, 0.5, 1.0], 1e-3, 0.01)
    assert eta_sweep.DEMO_TREE.to_json() == JAX_DEMO.to_json()


def _weights(trial):
    state = trial.store.load_checkpoint(0, 0, trial._fresh_state())
    return [p.detach() for p in state.net.parameters()]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("sweep")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        trials = eta_sweep.main(SMALL + ["--seed", "1", "--name", "t"])
    return cwd, trials


def test_sweep_writes_four_runs_from_one_init(sweep):
    cwd, trials = sweep
    runs = sorted(p.name for p in (cwd / "saved_runs").iterdir())
    assert runs == ["t-eta=0.0", "t-eta=0.2", "t-eta=0.5", "t-eta=1.0"]
    first = _weights(trials[0])
    for trial in trials:
        assert trial.state.total_steps == 2
        assert [w.shape for w in _weights(trial)] == [w.shape for w in first]
        assert all(torch.equal(a, b) for a, b in zip(_weights(trial), first))
        evals = [m["nashconv"] for _, m in trial.history if "nashconv" in m]
        assert len(evals) == 1 and math.isfinite(evals[0])
        params = json.loads((cwd / "saved_runs" / trial.store.name
                             / "params.json").read_text())
        assert params["rnad"]["logit_clip"] == 2.0
        assert params["rnad"]["eta"] == float(trial.store.name[6:])
    assert [t.cfg.eta for t in trials] == [0.0, 0.2, 0.5, 1.0]


def test_saved_tree_is_rnad_tpus(sweep):
    cwd, trials = sweep
    want = jax_tree_lib.generate_tree(JAX_DEMO, seed=1)
    got = torch_checkpoint.load_tree("small_tree",
                                     root=str(cwd / "saved_trees"),
                                     device="cpu")
    assert got.hash == want.hash == trials[0].tree.hash
    # the game is the one the config without its desc gives (the desc is
    # hashed, nothing else of it enters the tree)
    bare = jax_tree_lib.generate_tree(dataclasses.replace(JAX_DEMO, desc=""),
                                      seed=1)
    assert bare.hash == -1223469427354289570 != got.hash
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(bare.value))
    meta = json.loads((cwd / "saved_trees" / "small_tree"
                       / "meta.json").read_text())
    assert meta["desc"] == JAX_DEMO.desc


def test_load_tree_takes_rnad_tpus_store(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tree = jax_tree_lib.generate_tree(
        TreeConfig(max_actions=3, max_transitions=2, depth_bound=2), seed=2)
    jax_checkpoint.save_tree(tree, "jt", root=str(tmp_path / "saved_trees"))
    trials = eta_sweep.main(SMALL + ["--load-tree", "jt", "--etas", "0",
                                     "0.5", "--name", "l"])
    assert [t.tree.hash for t in trials] == [tree.hash] * 2
    assert not (tmp_path / "saved_trees" / "small_tree").exists()
    assert sorted(p.name for p in (tmp_path / "saved_runs").iterdir()) == [
        "l-eta=0.0", "l-eta=0.5"]
