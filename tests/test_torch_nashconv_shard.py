"""The port's node-sharded NashConv (``metrics/nashconv_shard.py``) against
its one-device induction and ``rnad_tpu``'s ``nashconv_sharded``.

The ranks are spawned CPU processes over gloo (``multiprocess_check.
run_nashconv``, with a time limit).  The conftest's small tree has 147
nodes, so 4 ranks hold 37 nodes each and the last one 36 and a pad node:
the padding is exercised (147 % 4 != 0), as it is on rnad_tpu's 8 virtual
devices (147 % 8 != 0).  Per-node best-response values agree within rtol
1e-6 / atol 1e-6 for an untrained net's joint policy, and the stored
exact solution scores NashConv 0 (< 1e-5; tests/test_sharding.py:288-310).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rnad_tpu.config import NetConfig
from rnad_tpu.metrics import nashconv as jax_nc
from rnad_tpu.metrics import nashconv_shard as jax_ncs
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.parallel import mesh as jax_mesh
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch.metrics import nashconv as torch_nc
from rnad_tpu_torch.metrics import nashconv_shard as torch_ncs
from rnad_tpu_torch.parallel import runtime
from rnad_tpu_torch.utils import checkpoint
from tests.torch_parity import torch_tree

RANKS = 4
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def joint(small_tree):
    """An untrained width-16 MLP's joint policy, from rnad_tpu."""
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=3, width=16))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(2), 3)
    apply_fn = lambda v, obs: jax_nets.apply_eval(net, v, obs)
    return np.array(jax_nc.joint_policy_all_nodes(small_tree, apply_fn,
                                                  variables))


@pytest.fixture(scope="module")
def tree_dir(small_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("nc_trees")
    return checkpoint.save_tree(torch_tree(small_tree), "small",
                                root=str(root))


def _sharded(tree_dir, policy, tmp_path):
    np.save(tmp_path / "policy.npy", policy)
    out = tmp_path / "values.npz"
    result = mpc.run_nashconv(RANKS, tree_dir, str(tmp_path / "policy.npy"),
                              str(out), device="cpu", timeout=240)
    assert [r["num_processes"] for r in result["ranks"]] == [RANKS] * RANKS
    # every rank holds the whole result
    assert len({r["nashconv"] for r in result["ranks"]}) == 1
    return result, np.load(out)


def test_sharded_matches_one_device_and_rnad_tpu(small_tree, joint,
                                                 tree_dir, tmp_path):
    assert small_tree.size % RANKS != 0  # a pad node
    _, got = _sharded(tree_dir, joint, tmp_path)
    ref = torch_nc.nashconv_root(torch_tree(small_tree),
                                 torch.from_numpy(joint))
    theirs = jax_ncs.nashconv_sharded(small_tree, joint,
                                      jax_mesh.make_mesh())
    for field in ("row_best", "col_best"):
        np.testing.assert_allclose(got[field], getattr(ref, field).numpy(),
                                   **TOL, err_msg=f"{field} vs one device")
        np.testing.assert_allclose(got[field],
                                   np.asarray(getattr(theirs, field)),
                                   **TOL, err_msg=f"{field} vs rnad_tpu")


def test_sharded_solution_scores_zero(small_tree, tree_dir, tmp_path):
    result, _ = _sharded(tree_dir, np.asarray(small_tree.solution),
                         tmp_path)
    assert abs(result["nashconv"]) < 1e-5


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_every_child_has_one_owning_rank(small_tree, world):
    """Across the ranks' local-parent-cell tables every node but the root
    and the absorbing state has its parent cell on exactly one rank, and
    that cell holds it in the rank's node-minor block."""
    index = np.asarray(small_tree.index)
    S, T, A = index.shape[0], index.shape[1], index.shape[2]
    s_pad = -(-S // world) * world
    sd = s_pad // world
    n_loc = T * A * A * sd
    tables = [torch_ncs.local_parent_cells(index, r, sd, s_pad)
              for r in range(world)]
    owned = sum((t < n_loc).astype(int) for t in tables)
    assert owned[0] == 0 and owned[1] == 0
    assert (owned[2:S] == 1).all() and (owned[S:] == 0).all()
    for r, table in enumerate(tables):
        for j in np.nonzero(table < n_loc)[0]:
            cell3, col = divmod(int(table[j]), sd)
            t, rc = divmod(cell3, A * A)
            assert index[r * sd + col, t, rc // A, rc % A] == j


def test_one_rank_in_process_equals_nashconv_root(small_tree, joint):
    """A one-rank group (the world this process spans) gives
    ``nashconv_root``'s values bitwise: adding no other rank's zeros."""
    group = runtime.data_group("cpu")
    try:
        tree = torch_tree(small_tree)
        got = torch_ncs.nashconv_sharded(tree, torch.from_numpy(joint),
                                         group)
    finally:
        runtime.shutdown()
    assert not dist.is_initialized()
    ref = torch_nc.nashconv_root(tree, torch.from_numpy(joint))
    assert torch.equal(got.row_best, ref.row_best)
    assert torch.equal(got.col_best, ref.col_best)
    assert got.reach_probability[1] == 1.0
