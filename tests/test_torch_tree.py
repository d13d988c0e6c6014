"""rnad_tpu_torch tree generation and tree store against rnad_tpu.

The port draws from numpy's generator in rnad_tpu's exact order and solves
with a copy of its numpy simplex, so the games are identical.  rnad_tpu's
default solver is native C++; its values may differ from the numpy path's
in the last bits of float64 (measured at most 1.2e-32 on the demo tree),
which the f32 tensors absorb within atol 1e-6 but which enter the content
hash: the port's hash equals rnad_tpu's numpy-path hash, not the native
one's.
"""

import dataclasses

import numpy as np
import pytest

import rnad_tpu.native
from rnad_tpu.config import ShapingRule, TreeConfig
from rnad_tpu.env import tree as jax_tree_lib
from rnad_tpu.utils import checkpoint as jax_checkpoint
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import tree as torch_tree_lib
from rnad_tpu_torch.utils import checkpoint as torch_checkpoint

DEMO = dict(max_actions=3, max_transitions=2, transition_threshold=0.3,
            depth_bound=4)
_EXACT = ("index", "chance", "legal", "solution", "depth")
_CLOSE = ("value", "expected_value", "root_value")


def _configs():
    rule = dict(delta=-1, stochastic_delta=-2, stochastic_prob=0.5)
    jax_cfg = TreeConfig(**DEMO, depth_bound_rule=ShapingRule(**rule))
    torch_cfg = torch_config.TreeConfig(
        **DEMO, depth_bound_rule=torch_config.ShapingRule(**rule))
    return jax_cfg, torch_cfg


def _no_native(*args, **kw):
    raise RuntimeError("native solver disabled for this test")


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_tree_matches(seed):
    jax_cfg, torch_cfg = _configs()
    want = jax_tree_lib.generate_tree(jax_cfg, seed=seed)
    got = torch_tree_lib.generate_tree(torch_cfg, seed=seed, device="cpu")
    assert (got.max_actions, got.max_transitions, got.max_depth) == (
        want.max_actions, want.max_transitions, want.max_depth)
    for k in _EXACT:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for k in _CLOSE:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    torch_tree_lib.validate(got)


def test_demo_tree_shape_and_hash(monkeypatch):
    jax_cfg, torch_cfg = _configs()
    got = torch_tree_lib.generate_tree(torch_cfg, seed=0, device="cpu")
    assert got.size == 306 and got.max_depth == 4
    native = jax_tree_lib.generate_tree(jax_cfg, seed=0)
    monkeypatch.setattr(rnad_tpu.native, "solve_zero_sum_batch_native",
                        _no_native)
    numpy_path = jax_tree_lib.generate_tree(jax_cfg, seed=0)
    assert got.hash == numpy_path.hash
    assert native.hash != numpy_path.hash


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
    with pytest.raises(NotImplementedError, match="equilibrium_selection"):
        torch_tree_lib.generate_tree(
            dataclasses.replace(torch_cfg, equilibrium_selection="pure"),
            device="cpu")
