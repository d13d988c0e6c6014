"""The generic rollout turn of rnad_tpu_torch.env.engine against rnad_tpu's
generic turn, under shared noise.

An EquiNet with solver features plays the same episodes as rnad_tpu's
(indices, actions and rewards equal; policy and values within atol 1e-5
except on counted half-steps whose observed game the two float32 RM+
solves part on, as ``solver_device.agreement`` counts them),
and an MLP played through the generic turn equals its fused-turn (K1)
rollout.  The route follows ``rollout_rows_actor`` as rnad_tpu's
``resolve_rows_actor`` does, errors included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import (diverged_solves, rollout_noise,
                                torch_equinet, torch_mlp, torch_tree)

A, B = 3, 256


@pytest.mark.parametrize("solver_iters,solver_prime,seed",
                         [(16, True, 3), (16, False, 5), (0, False, 7)])
def test_equinet_rollout_matches(small_tree, solver_iters, solver_prime,
                                 seed):
    net = jax_nets.build_net(NetConfig(type="EquiNet", max_actions=A,
                                       channels=8, depth=2,
                                       solver_iters=solver_iters,
                                       solver_prime=solver_prime))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(seed), A)
    packed = jax_stepping.make_packed_tables(small_tree)
    key = jax.random.PRNGKey(seed + 1)
    actor = lambda vs, obs: jax_nets.apply_eval(net, vs, obs)
    want = jax_engine.rollout_from(small_tree, actor, variables, key,
                                   jnp.ones((B,), jnp.int32),
                                   small_tree.max_depth, packed)
    tree = torch_tree(small_tree)
    noise = rollout_noise(key, B, A, small_tree.max_transitions,
                          small_tree.max_depth)
    tnet = torch_equinet(variables["params"], A, 8, 2, solver_iters,
                         solver_prime)
    got = torch_engine.rollout_from(
        tree, torch_stepping.make_packed_tables(tree), tnet,
        torch.ones((B,), dtype=torch.int32), noise=noise)
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    # half-steps whose observed game the two float32 solves part on are
    # counted, and may differ (solver_device.agreement)
    keep = np.ones(got.indices.shape, bool)
    if solver_iters:
        obs, _ = torch_engine.trajectory_observations(
            torch_stepping.make_packed_tables(tree), got)
        keep = ~diverged_solves(obs.reshape(-1, 2, A, A).numpy(),
                                solver_iters).reshape(keep.shape)
        assert keep.mean() >= 0.97, keep.mean()
    for f in ("values", "policy"):
        np.testing.assert_allclose(getattr(got, f).numpy()[keep],
                                   np.asarray(getattr(want, f))[keep],
                                   rtol=0, atol=1e-5, err_msg=f)


def test_mlp_generic_turn_equals_fused_turn(small_tree):
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A, width=32))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(2), A)
    tnet = torch_mlp(variables["params"], A, 32)
    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    noise = rollout_noise(jax.random.PRNGKey(4), B, A,
                          small_tree.max_transitions, small_tree.max_depth)
    init = torch.ones((B,), dtype=torch.int32)
    fused = torch_engine.rollout_from(tree, packed, tnet, init, noise=noise)
    generic = torch_engine.rollout_from(tree, packed, tnet, init,
                                        noise=noise, rows_actor="off")
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(generic, f), getattr(fused, f)), f
    for f in ("values", "policy"):
        torch.testing.assert_close(getattr(generic, f), getattr(fused, f),
                                   rtol=0, atol=1e-6)


def test_route_resolution(small_tree):
    mlp = torch_nets.MLP(A, 8)
    equi = torch_nets.EquiNet(A, channels=4, depth=1)
    assert torch_engine.uses_fused_turn(mlp, "auto")
    assert torch_engine.uses_fused_turn(mlp, "on")
    assert not torch_engine.uses_fused_turn(mlp, "off")
    assert not torch_engine.uses_fused_turn(equi, "auto")
    assert not torch_engine.uses_fused_turn(equi, "off")
    # on the CPU the fused turn is its plain version, at any width
    assert torch_engine.uses_fused_turn(torch_nets.MLP(8, 512), "auto")
    with pytest.raises(ValueError, match="unknown rollout_rows_actor"):
        torch_engine.uses_fused_turn(mlp, "sometimes")


def test_rows_actor_on_with_equinet_raises_as_jax(small_tree):
    cfg = RNaDConfig(rollout_rows_actor="on")
    net = jax_nets.build_net(NetConfig(type="EquiNet", max_actions=A,
                                       channels=4, depth=1))
    with pytest.raises(ValueError) as want:
        jax_rnad.resolve_rows_actor(
            net, jax_stepping.make_packed_tables(small_tree), cfg)
    with pytest.raises(ValueError) as got:
        torch_engine.uses_fused_turn(
            torch_nets.EquiNet(A, channels=4, depth=1), "on")
    assert str(got.value) == str(want.value)
