"""The port's native tree generator (rnad_tpu_torch/native.py and
env/tree.py::generate_tree_native) against rnad_tpu's, the depth index, the
reference-tree import, and the build's failure mode.

The generator is the same C++ built with the same flags, so every array
must be equal bitwise and the content hash the same; the flagship tree
(785,768 nodes) must have the hash its run records.
"""

import numpy as np
import pytest
import torch

from rnad_tpu.config import ShapingRule as JaxRule
from rnad_tpu.config import TreeConfig as JaxTreeConfig
from rnad_tpu.env import tree as jax_tree
from rnad_tpu.utils import checkpoint as jax_checkpoint
from rnad_tpu_torch import native
from rnad_tpu_torch.config import ShapingRule, TreeConfig
from rnad_tpu_torch.env import tree as torch_tree
from rnad_tpu_torch.utils import checkpoint as torch_checkpoint

CONFIGS = {
    # the demo tree (examples/eta_sweep.py) and the A = 5 "big" config of
    # tools/bench_suite.py cut to depth_bound 4
    "demo": dict(max_actions=3, max_transitions=2, transition_threshold=0.3,
                 depth_bound=4, rule=(-1, -2, 0.5)),
    "a5_depth4": dict(max_actions=5, max_transitions=2,
                      transition_threshold=0.25, depth_bound=4,
                      rule=(-1, -2, 0.55)),
}
FLAGSHIP = dict(max_actions=5, max_transitions=2, transition_threshold=0.25,
                depth_bound=6, rule=(-1, -2, 0.55))
FLAGSHIP_HASH = -3582253928252745740  # docs/runs/r4-flagship3.params.json


def _configs(kw):
    kw = dict(kw)
    rule = kw.pop("rule")
    return (TreeConfig(**kw, depth_bound_rule=ShapingRule(*rule)),
            JaxTreeConfig(**kw, depth_bound_rule=JaxRule(*rule)))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg, jcfg = _configs(CONFIGS[request.param])
    return (torch_tree.generate_tree_native(cfg, seed=0, device="cpu"),
            jax_tree.generate_tree_native(jcfg, seed=0))


def test_native_tree_equals_rnad_tpu(pair):
    got, want = pair
    assert got.hash == want.hash
    assert (got.size, got.max_depth) == (want.size, want.max_depth)
    a, b = torch_tree.tree_to_arrays(got), jax_tree.tree_to_arrays(want)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k
    torch_tree.validate(got)


def test_native_tree_differs_from_numpy_path():
    cfg, _ = _configs(CONFIGS["demo"])
    native_tree = torch_tree.generate_tree_native(cfg, seed=0, device="cpu")
    numpy_tree = torch_tree.generate_tree(cfg, seed=0, device="cpu")
    assert native_tree.hash != numpy_tree.hash


def test_depth_from_index_matches(pair):
    got, want = pair
    index, chance = got.index.numpy(), got.chance.numpy()
    depth = torch_tree.depth_from_index(index, chance)
    assert np.array_equal(depth, jax_tree.depth_from_index(index, chance))
    assert np.array_equal(depth, got.depth.numpy())


def test_cyclic_index_raises():
    index = np.zeros((3, 1, 1, 1), np.int32)
    index[1, 0, 0, 0] = 2
    index[2, 0, 0, 0] = 1  # a back edge
    chance = np.ones_like(index, dtype=np.float32)
    with pytest.raises(AssertionError):
        torch_tree.assert_index_array_is_tree(index)
    with pytest.raises(ValueError, match="cycle"):
        torch_tree.depth_from_index(index, chance)


def test_flagship_tree_hash():
    cfg, _ = _configs(FLAGSHIP)
    tree = torch_tree.generate_tree_native(cfg, seed=0, device="cpu")
    assert (tree.size, tree.max_depth, tree.hash) == (785768, 6,
                                                      FLAGSHIP_HASH)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that cannot run raises; nothing falls back to numpy."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing" / "g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    cfg, _ = _configs(CONFIGS["demo"])
    with pytest.raises(RuntimeError, match="build failed"):
        torch_tree.generate_tree_native(cfg, seed=0, device="cpu")
    assert not any((tmp_path / "build").glob("*.so"))


def test_failed_compile_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-no-such-flag",))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        native.library()
    assert not any((tmp_path / "build").iterdir())


def test_load_reference_tree_matches(tmp_path, pair):
    """A reference-format tree.tar imports as the same tree in both
    packages, the depth index recomputed."""
    got, _ = pair
    saved = {f"{k}_tensor": torch.as_tensor(v) for k, v in
             torch_tree.tree_to_arrays(got).items() if k != "depth"}
    saved.update(max_actions=got.max_actions,
                 max_transitions=got.max_transitions, hash=got.hash,
                 desc="test")
    torch.save(saved, tmp_path / "tree.tar")
    loaded = torch_checkpoint.load_reference_tree(str(tmp_path),
                                                  device="cpu")
    want = jax_checkpoint.load_reference_tree(str(tmp_path))
    a, b = torch_tree.tree_to_arrays(loaded), jax_tree.tree_to_arrays(want)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
        assert np.array_equal(a[k], torch_tree.tree_to_arrays(got)[k]), k
    assert (loaded.hash, loaded.max_depth) == (got.hash, got.max_depth)
