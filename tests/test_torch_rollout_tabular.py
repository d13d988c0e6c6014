"""rnad_tpu_torch.env.engine.rollout_tabular against rnad_tpu's.

Fed the Gumbel noise rnad_tpu draws from its key (per turn: split into
(k_row, k_col, k_ch), ``gumbel`` of shapes (B, A), (B, A) and (B, T)),
the rollout of a random joint policy and of the stored solution plays the
same episodes, with the same policies (1e-6) and values; rolled out under
``tree.solution`` its mean return is the root value within 3 standard
errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.env import engine as jax_engine
from rnad_tpu_torch.env import engine as torch_engine
from tests.torch_parity import torch_tree

B = 512


def _noise(key, B, A, T, num_turns):
    out = []
    for key_t in jax.random.split(key, num_turns):
        k_row, k_col, k_ch = jax.random.split(key_t, 3)
        out.append(tuple(
            torch.from_numpy(np.array(jax.random.gumbel(k, shape,
                                                        jnp.float32)))
            for k, shape in ((k_row, (B, A)), (k_col, (B, A)),
                             (k_ch, (B, T)))))
    return out


def _random_policy(tree, seed):
    rng = np.random.default_rng(seed)
    A = tree.max_actions
    p = rng.random((tree.index.shape[0], 2 * A)).astype(np.float32)
    p[rng.random(p.shape) < 0.2] = 0.0
    return p


@pytest.mark.parametrize("policy", ["solution", "random"])
def test_rollout_tabular_matches(small_tree, policy):
    joint = (np.asarray(small_tree.solution) if policy == "solution"
             else _random_policy(small_tree, 0))
    key = jax.random.PRNGKey(4)
    want = jax_engine.rollout_tabular(small_tree, jnp.asarray(joint), key, B)
    A, T = small_tree.max_actions, small_tree.max_transitions
    got = torch_engine.rollout_tabular(
        torch_tree(small_tree), torch.from_numpy(joint.copy()), B,
        noise=_noise(key, B, A, T, small_tree.max_depth))
    for f in ("indices", "actions", "rewards", "values"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.policy.numpy(), np.asarray(want.policy),
                               rtol=0, atol=1e-6)


def test_solution_rollout_returns_the_root_value(small_tree):
    tree = torch_tree(small_tree)
    traj = torch_engine.rollout_tabular(
        tree, tree.solution, 16384,
        generator=torch.Generator().manual_seed(0))
    returns = torch_engine.episode_returns(traj)
    se = float(returns.std()) / returns.numel() ** 0.5
    assert abs(float(returns.mean()) - float(tree.root_value[1, 0])) < 3 * se
    assert traj.indices.shape == (2 * tree.max_depth, 16384)
