"""rnad_tpu_torch tree generation, equilibrium selection and tree store
against rnad_tpu.

The port draws from numpy's generator in rnad_tpu's exact order and solves
each level with the same native C++ simplex as rnad_tpu's default, so every
array and the content hash are equal.  The numpy simplex, the plain version
of both packages, rounds some float64 game values otherwise in their last
bits (at most 1.85e-32 on the CLI's demo tree), which the f32 tensors
absorb but the content hash does not: the port's numpy copy gives
rnad_tpu's numpy-path hash.  Equilibrium selection stores rnad_tpu's
solutions and leaves the hash alone.
"""

import dataclasses

import numpy as np
import pytest

import rnad_tpu.native
from rnad_tpu.config import ShapingRule, TreeConfig
from rnad_tpu.env import tree as jax_tree_lib
from rnad_tpu.utils import checkpoint as jax_checkpoint
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import solver as torch_solver
from rnad_tpu_torch.env import tree as torch_tree_lib
from rnad_tpu_torch.utils import checkpoint as torch_checkpoint

DEMO = dict(max_actions=3, max_transitions=2, transition_threshold=0.3,
            depth_bound=4)
_EXACT = ("index", "chance", "legal", "solution", "depth")
_CLOSE = ("value", "expected_value", "root_value")
# examples/eta_sweep.py's tree at seeds 0-4 and the train CLI's --demo tree
# (depth rule -1 alone), with rnad_tpu's default hashes
SWEEP_RULE = dict(delta=-1, stochastic_delta=-2, stochastic_prob=0.5)
HASHES = [("sweep", 0, 306, 5087467122622553942),
          ("sweep", 1, 190, -1223469427354289570),
          ("sweep", 2, 192, 6936241201651728500),
          ("sweep", 3, 321, -2238001362224698331),
          ("sweep", 4, 319, -4002637924140080217),
          ("cli", 0, 1648, -3732021709909792432)]


def _configs():
    rule = dict(delta=-1, stochastic_delta=-2, stochastic_prob=0.5)
    jax_cfg = TreeConfig(**DEMO, depth_bound_rule=ShapingRule(**rule))
    torch_cfg = torch_config.TreeConfig(
        **DEMO, depth_bound_rule=torch_config.ShapingRule(**rule))
    return jax_cfg, torch_cfg


def _no_native(*args, **kw):
    raise RuntimeError("native solver disabled for this test")


def _assert_trees_equal(got, want):
    assert (got.max_actions, got.max_transitions, got.max_depth) == (
        want.max_actions, want.max_transitions, want.max_depth)
    for k in _EXACT + _CLOSE:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert got.hash == want.hash


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_tree_matches(seed):
    jax_cfg, torch_cfg = _configs()
    want = jax_tree_lib.generate_tree(jax_cfg, seed=seed)
    got = torch_tree_lib.generate_tree(torch_cfg, seed=seed, device="cpu")
    _assert_trees_equal(got, want)
    torch_tree_lib.validate(got)


def test_demo_tree_shape_and_hash(monkeypatch):
    jax_cfg, torch_cfg = _configs()
    got = torch_tree_lib.generate_tree(torch_cfg, seed=0, device="cpu")
    assert got.size == 306 and got.max_depth == 4
    native = jax_tree_lib.generate_tree(jax_cfg, seed=0)
    assert got.hash == native.hash == 5087467122622553942
    monkeypatch.setattr(rnad_tpu.native, "solve_zero_sum_batch_native",
                        _no_native)
    numpy_path = jax_tree_lib.generate_tree(jax_cfg, seed=0)
    assert native.hash != numpy_path.hash


def test_numpy_path_matches_rnad_tpu_numpy_path(monkeypatch):
    """The port's numpy simplex (the plain version) in place of the native
    one gives rnad_tpu's numpy-path tree, hash included."""
    jax_cfg, torch_cfg = _configs()
    monkeypatch.setattr(rnad_tpu.native, "solve_zero_sum_batch_native",
                        _no_native)
    monkeypatch.setattr(torch_solver, "solve_zero_sum_batch",
                        lambda p, r, c: torch_solver._solve_batch_numpy(
                            np.asarray(p, np.float64), r, c))
    for seed in (0, 7):
        want = jax_tree_lib.generate_tree(jax_cfg, seed=seed)
        got = torch_tree_lib.generate_tree(torch_cfg, seed=seed,
                                           device="cpu")
        _assert_trees_equal(got, want)


@pytest.mark.parametrize("kind,seed,size,want_hash", HASHES)
def test_default_hash_is_rnad_tpu_default(kind, seed, size, want_hash):
    rule = SWEEP_RULE if kind == "sweep" else dict(delta=-1)
    jax_cfg = TreeConfig(**DEMO, depth_bound_rule=ShapingRule(**rule))
    torch_cfg = torch_config.TreeConfig(
        **DEMO, depth_bound_rule=torch_config.ShapingRule(**rule))
    got = torch_tree_lib.generate_tree(torch_cfg, seed=seed, device="cpu")
    want = jax_tree_lib.generate_tree(jax_cfg, seed=seed)
    assert (got.size, got.max_depth) == (size, 4)
    assert got.hash == want.hash == want_hash


@pytest.fixture(scope="module")
def vertex_pair():
    jax_cfg, torch_cfg = _configs()
    return (jax_tree_lib.generate_tree(jax_cfg, seed=0),
            torch_tree_lib.generate_tree(torch_cfg, seed=0, device="cpu"))


@pytest.mark.parametrize("mode", ["pure", "mixed", "enummixed"])
def test_selection_stores_rnad_tpu_solutions(mode, vertex_pair, tmp_path):
    """Generation-time selection stores rnad_tpu's solutions under the
    vertex tree's hash, each an exact equilibrium (NashConv 0); the
    post-pass ``select_equilibria`` does the same on a loaded tree."""
    from rnad_tpu_torch.metrics import nashconv as torch_nashconv

    jax_cfg, torch_cfg = _configs()
    jax_vertex, vertex = vertex_pair
    want = jax_tree_lib.generate_tree(
        dataclasses.replace(jax_cfg, equilibrium_selection=mode), seed=0)
    got = torch_tree_lib.generate_tree(
        dataclasses.replace(torch_cfg, equilibrium_selection=mode), seed=0,
        device="cpu")
    _assert_trees_equal(got, want)
    assert got.hash == vertex.hash
    changed = (got.solution != vertex.solution).any(1)
    assert int(changed.sum()) > 0  # the demo tree has degenerate nodes
    oracle = torch_nashconv.nashconv_pure(got, got.solution).nashconv()
    assert abs(float(oracle)) < 1e-5

    root = str(tmp_path / "trees")
    torch_checkpoint.save_tree(vertex, name="v", root=root)
    loaded = torch_checkpoint.load_tree("v", root=root, device="cpu")
    selected = torch_tree_lib.select_equilibria(loaded, mode)
    np.testing.assert_array_equal(
        selected.solution.numpy(),
        np.asarray(jax_tree_lib.select_equilibria(jax_vertex, mode).solution))
    assert selected.hash == vertex.hash
    assert torch_tree_lib.select_equilibria(loaded, "vertex") is loaded


def test_tree_store_round_trip(tmp_path, small_tree):
    root = str(tmp_path / "trees")
    jax_checkpoint.save_tree(small_tree, name="t", root=root)
    got = torch_checkpoint.load_tree("t", root=root, device="cpu")
    for k in _EXACT + _CLOSE:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(small_tree, k)),
                                      err_msg=k)
    assert got.index.dtype == got.depth.dtype
    assert got.hash == small_tree.hash
    assert got.max_depth == small_tree.max_depth
    # and back: the port's save loads into rnad_tpu unchanged
    torch_checkpoint.save_tree(got, name="u", root=root)
    back = jax_checkpoint.load_tree("u", root=root)
    for k in _EXACT + _CLOSE:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(small_tree, k)),
                                      err_msg=k)


def test_invariants_and_rejections():
    _, torch_cfg = _configs()
    tree = torch_tree_lib.generate_tree(torch_cfg, seed=2, device="cpu")
    torch_tree_lib.assert_index_is_tree(tree)
    bad = tree.index.clone()
    bad[2, 0, 0, 0] = 1  # an edge back to the root
    with pytest.raises(AssertionError):
        torch_tree_lib.assert_index_is_tree(
            dataclasses.replace(tree, index=bad))
    with pytest.raises(ValueError, match="equilibrium selection mode"):
        torch_tree_lib.generate_tree(
            dataclasses.replace(torch_cfg, equilibrium_selection="best"),
            device="cpu")
