"""The depth-1 MLP's learner under the noisy lift against rnad_tpu's (the
control of r5-noisy-conv, r5-noisy-mlp).

From rnad_tpu's init (carried over with ``params_from_flax``) and rnad_tpu's
lift (mix, bias) (``transform_from_arrays``):

- one learner step on rnad_tpu's rollout, its stored lifted observations
  carried across, matches ``learn_jit`` within the tolerances of the
  ConvNet twin (tests/test_torch_rnad_offpolicy.py): weights within atol
  1e-6, losses within rtol 1e-5;
- a segment of 20 fused train steps, each fed the noise rnad_tpu's step
  draws from its key (Gumbel noise and the lift's eps), plays episodes of
  the same total length at every step, keeps each step's losses within
  atol 1e-5 (means over 768 half-steps whose float32 sums are taken in
  another order; measured at most 3.8e-6), and ends on weights within
  1e-6 of rnad_tpu's (measured 1.2e-7) and on its NashConv within 1e-5.
  Run on, this seed first parts at step 27, where one lane's episode
  flips at a near-tie; a segment is as far as parity reaches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnad_tpu.config import NetConfig, ObsTransformConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import obs_transform as jax_tf
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import obs_transform as torch_tf
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import torch_trajectory, torch_tree, train_step_noise

A, WIDTH, B = 3, 32, 128
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)
LIFT = dict(kind="lift", channels=4, sigma=0.15, bias_scale=1.0, seed=0)
C = LIFT["channels"] + 1
SEGMENT = 20


def _setup(small_tree, seed, jax_kw=None):
    cfg = RNaDConfig(**CFG, obs_transform=ObsTransformConfig(**LIFT),
                     **(jax_kw or {}))
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    fns = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(seed), A, cfg)
    tnet = torch_nets.MLP(A, WIDTH, in_channels=C)
    tnet.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, state.variables["params"])))
    mix, bias = jax_tf.transform_params(ObsTransformConfig(**LIFT), A)
    tcfg = torch_config.RNaDConfig(
        **CFG, obs_transform=torch_config.ObsTransformConfig(**LIFT))
    lift = torch_tf.transform_from_arrays(tcfg.obs_transform,
                                          np.asarray(mix), np.asarray(bias))
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    return fns, state, tcfg, lift, tstate


def _max_param_gap(module, params):
    got = torch_nets.params_to_flax(module)
    return max(float(np.abs(got[layer][leaf]
                            - np.asarray(params[layer][leaf])).max())
               for layer in params for leaf in ("kernel", "bias"))


def test_mlp_lift_learner_step_matches(small_tree):
    _assert_mlp_lift_learner_step(small_tree)


def test_mlp_lift_learner_step_matches_rnad_tpus_amb_step(small_tree):
    """rnad_tpu's step in its batch-minor layout, on its own rollout (whose
    record is then (T, A, B)), against the port's (T, B, A) step on that
    rollout transposed back."""
    _assert_mlp_lift_learner_step(small_tree, dict(learner_layout="amb"))


def _assert_mlp_lift_learner_step(small_tree, jax_kw=None):
    (_, rollout_jit, learn_jit, _), state, tcfg, _, tstate = _setup(
        small_tree, 3, jax_kw)
    state, traj = rollout_jit(state)
    assert traj.obs.shape[2] == C
    new, metrics = learn_jit(state, traj, jnp.float32(0.5))
    tree = torch_tree(small_tree)
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(tree),
        torch_trajectory(traj.replace(policy=traj.policy_bma())), 0.5, tcfg)
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert _max_param_gap(tstate.net, new.variables["params"]) <= 1e-6
    assert _max_param_gap(tstate.net_target,
                          new.variables_target["params"]) <= 1e-6


def test_mlp_lift_segment_matches(small_tree):
    (step, _, _, nashconv_fn), state, tcfg, lift, tstate = _setup(
        small_tree, 5)
    tree = torch_tree(small_tree)
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree), tcfg, lift)
    T, md = small_tree.max_transitions, small_tree.max_depth
    for n in range(SEGMENT):
        alpha = jax_rnad.alpha_schedule(n % 4, 4)
        noise = train_step_noise(state.key, B, A, T, md,
                                 channels=LIFT["channels"])
        state, metrics = step(state, jnp.float32(alpha))
        _, tmetrics = tstep(tstate, alpha, noise)
        np.testing.assert_allclose(tmetrics["traj_len"].item(),
                                   float(metrics["traj_len"]), rtol=0)
        for k in ("loss", "loss_v", "loss_nerd"):
            np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {n}: {k}")
        if n % 4 == 3:  # an update boundary
            state = jax_rnad.rotate_regularization_nets(state)
            torch_rnad.rotate_regularization_nets(tstate)
    assert tstate.total_steps == int(state.total_steps) == SEGMENT
    assert _max_param_gap(tstate.net, state.variables["params"]) <= 1e-6
    assert _max_param_gap(tstate.net_target,
                          state.variables_target["params"]) <= 1e-6
    want = float(nashconv_fn(state.variables_target).nashconv())
    got = float(torch_rnad.nashconv(tree, tstate.net_target,
                                    obs_transform=lift).nashconv())
    assert abs(got - want) < 1e-5
