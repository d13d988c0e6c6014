"""rnad_tpu_torch.env.engine against rnad_tpu.env.engine under shared noise.

The noise is drawn with jax.random under rnad_tpu's key discipline and
handed to both packages, so the episodes must be the same: indices, actions
and rewards equal; policy and values within rtol 1e-5, atol 1e-6 (the port
runs the fused two-head MLP, whose reduction order differs from the
separate-head forward).  The learner's regathered observations equal
rnad_tpu's stored ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import rollout_noise, torch_mlp, torch_tree

A, WIDTH, B = 3, 32, 256


@pytest.fixture(scope="module", params=[3, 11])
def rollouts(request, small_tree):
    seed = request.param
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(seed), A)
    packed = jax_stepping.make_packed_tables(small_tree)
    key = jax.random.PRNGKey(seed)
    init = jnp.ones((B,), jnp.int32)
    actor = lambda vs, obs: jax_nets.apply_eval(net, vs, obs)
    want = jax_engine.rollout_from(small_tree, actor, variables, key, init,
                                   small_tree.max_depth, packed,
                                   store_obs=True)
    tree = torch_tree(small_tree)
    tpacked = torch_stepping.make_packed_tables(tree)
    noise = rollout_noise(key, B, A, small_tree.max_transitions,
                          small_tree.max_depth)
    got = torch_engine.rollout_from(
        tree, tpacked, torch_mlp(variables["params"], A, WIDTH),
        torch.ones((B,), dtype=torch.int32), tree.max_depth, noise=noise)
    return want, got, tpacked


def test_rollout_same_episodes(rollouts):
    want, got, _ = rollouts
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("values", "policy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(
        torch_engine.episode_returns(got).numpy(),
        np.asarray(jax_engine.episode_returns(want)))


def test_regathered_observations_equal_stored(rollouts):
    want, got, tpacked = rollouts
    obs, masks = torch_engine.trajectory_observations(tpacked, got)
    w_obs, w_masks = jax_engine.trajectory_observations(None, want)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(w_obs))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(w_masks))


def test_trajectory_contract(rollouts):
    want, got, _ = rollouts
    assert got.num_half_steps == want.num_half_steps
    assert (got.batch_size, got.num_actions) == (B, A)
    np.testing.assert_array_equal(got.turns.numpy(), np.asarray(want.turns))
    np.testing.assert_array_equal(got.valid().numpy(),
                                  np.asarray(want.valid()))
    np.testing.assert_array_equal(got.actions_oh().numpy(),
                                  np.asarray(want.actions_oh()))
    rewards = got.rewards.numpy()
    indices = got.indices.numpy()
    assert (rewards[0::2] == 0).all()  # rewards only on col half-steps
    for t in range(2, got.num_half_steps, 2):
        assert (indices[t][indices[t - 1] == 0] == 0).all()  # absorbed


def test_drawn_noise_is_gumbel():
    gen = torch.Generator().manual_seed(0)
    g_act, g_ch = torch_engine.turn_noise(20000, 3, 2, gen, "cpu")
    assert g_act.shape == (40000, 3) and g_ch.shape == (20000, 2)
    assert g_ch.is_contiguous() and torch.isfinite(g_act).all()
    # Gumbel(0, 1): mean = Euler's gamma, variance = pi^2 / 6
    x = g_act.double()
    assert abs(float(x.mean()) - 0.5772156649) < 0.01
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03
