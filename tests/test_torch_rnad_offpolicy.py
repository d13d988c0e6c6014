"""The port's buffered (off-policy) path and its observation lift against
rnad_tpu's.

- A buffered ``RNaD.run`` (``n_batches_per_buffer=4, buffer_mod=2``) rolls
  out, and samples the same slots and lanes, on the same steps as
  rnad_tpu's.
- One sampled learner step on rnad_tpu's slots and lanes, and one ConvNet
  learner step under the lift on rnad_tpu's rollout (its stored lifted
  observations carried across), match ``learn_jit.sampled`` and
  ``learn_jit``: weights within atol 1e-6 and losses within rtol 1e-5 (the
  tolerances of tests/test_torch_rnad.py); the ConvNet's BatchNorm
  statistics, and the EMA target's, within 1e-6.
- The lifted rollout, fed rnad_tpu's noise, plays the same episodes and
  stores the same observations (atol 1e-6; policy and values 1e-5), and
  NashConv under the lift equals rnad_tpu's ``nashconv_fn`` whole-tree and
  chunked (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, ObsTransformConfig, RNaDConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.learn import buffer as jax_buffer
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import obs_transform as jax_tf
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.learn import buffer as torch_buffer
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import obs_transform as torch_tf
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import (lift_rollout_noise, torch_convnet, torch_mlp,
                                torch_trajectory, torch_tree)

A, WIDTH, B = 3, 32, 128
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)
BUFFERED = dict(n_batches_per_buffer=4, buffer_mod=2)
LIFT = dict(kind="lift", channels=4, sigma=0.15, bias_scale=1.0, seed=0)
CONV = dict(type="ConvNet", max_actions=A, channels=8, depth=2)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, atol, what):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what}{k}")


def _assert_metrics_close(tmetrics, metrics):
    assert set(tmetrics) == set(metrics)
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)


def test_buffered_run_rolls_out_and_samples_as_rnad_tpu(small_tree,
                                                        tmp_path,
                                                        monkeypatch):
    kw = dict(batch_size=32, bounds=(2,), delta_m=(5,), lr=1e-3, **BUFFERED)
    jrun = jax_rnad.RNaD(small_tree, RNaDConfig(**kw),
                         NetConfig(max_actions=A, width=16),
                         directory_name="jax", runs_root=str(tmp_path))
    want = []
    roll, sampled = jrun.rollout_jit, jrun.learn_jit.sampled

    def rollout_jit(state):
        want.append(("rollout", int(state.total_steps)))
        return roll(state)

    def learn_jit(*args):
        raise AssertionError("the buffered loop samples")

    def learn_sampled(state, slots, lanes, alpha):
        want.append(("learn", int(state.total_steps), len(slots),
                     None if lanes is None
                     else [np.asarray(x).tolist() for x in lanes]))
        return sampled(state, slots, lanes, alpha)

    learn_jit.sampled = learn_sampled
    jrun.rollout_jit, jrun.learn_jit = rollout_jit, learn_jit
    jrun.run(log_mod=1)

    got = []
    trun = torch_rnad.RNaD(torch_tree(small_tree),
                           torch_config.RNaDConfig(**kw),
                           torch_config.NetConfig(max_actions=A, width=16),
                           directory_name="torch", runs_root=str(tmp_path),
                           device="cpu")
    rollout, plan = torch_rnad.rollout, torch_buffer.TrajectoryBuffer.plan

    def record_rollout(state, *args, **kwargs):
        got.append(("rollout", state.total_steps))
        return rollout(state, *args, **kwargs)

    def record_plan(self, batch_size, rng=None):
        slots, lanes = plan(self, batch_size, rng)
        got.append(("learn", trun.state.total_steps, len(slots),
                    None if lanes is None
                    else [x.tolist() for x in lanes]))
        return slots, lanes

    monkeypatch.setattr(torch_rnad, "rollout", record_rollout)
    monkeypatch.setattr(torch_buffer.TrajectoryBuffer, "plan", record_plan)
    trun.run(log_mod=1)

    assert got == want
    assert [e[1] for e in got if e[0] == "rollout"] == [0, 2, 4, 6, 8]
    assert [e[2] for e in got if e[0] == "learn"] == [1, 1, 2, 2, 3, 3, 4, 4,
                                                       4, 4]
    steps = [s for s, m in trun.history if "loss" in m]
    assert steps == list(range(1, 11))
    assert all(np.isfinite(v) for _, m in trun.history for v in m.values())
    assert {k for _, m in trun.history for k in m} >= {"steps_per_s",
                                                       "env_steps_per_s"}


def test_one_sampled_learner_step_matches(small_tree):
    _assert_one_sampled_learner_step(small_tree)


def test_one_sampled_learner_step_matches_rnad_tpus_amb_step(small_tree):
    """rnad_tpu's sampled step in its batch-minor layout (its buffered
    rollouts stay (T, B, A)) against the port's (T, B, A) step."""
    _assert_one_sampled_learner_step(small_tree,
                                     dict(learner_layout="amb"))


def _assert_one_sampled_learner_step(small_tree, jax_kw=None):
    cfg = RNaDConfig(**CFG, **BUFFERED, **(jax_kw or {}))
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    _, rollout_jit, learn_jit, _ = jax_rnad.make_rnad_fns(net, small_tree,
                                                          cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(2), A, cfg)
    buf = jax_buffer.TrajectoryBuffer(4)
    for _ in range(3):
        state, traj = rollout_jit(state)
        buf.append(traj)
    slots, lanes = buf.plan(B, np.random.default_rng(7))
    assert len(slots) == 3
    new, metrics = learn_jit.sampled(state, slots, lanes, jnp.float32(0.5))

    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    tstate = torch_rnad.init_train_state(
        torch_mlp(state.variables["params"], A, WIDTH), torch.Generator())
    # raw observations: the port's learner regathers them (K2)
    tslots = [torch_trajectory(s, keep_obs=False) for s in slots]
    traj = torch_buffer.collate_slots(
        tslots, [torch.from_numpy(np.array(x)) for x in lanes])
    tmetrics = torch_rnad.learn_step(
        tstate, packed, traj, 0.5,
        torch_config.RNaDConfig(**CFG, **BUFFERED))
    _assert_metrics_close(tmetrics, metrics)
    _assert_tree_close(torch_nets.params_to_flax(tstate.net),
                       new.variables["params"], 1e-6, "net")
    _assert_tree_close(torch_nets.params_to_flax(tstate.net_target),
                       new.variables_target["params"], 1e-6, "target")


def _lift_fns(small_tree, net_cfg, **kw):
    cfg = RNaDConfig(**dict(CFG, **kw),
                     obs_transform=ObsTransformConfig(**LIFT))
    net = jax_nets.build_net(NetConfig(**net_cfg))
    fns = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(3), A, cfg)
    return cfg, net, fns, state


def _torch_lift():
    mix, bias = jax_tf.transform_params(ObsTransformConfig(**LIFT), A)
    return torch_tf.transform_from_arrays(
        torch_config.ObsTransformConfig(**LIFT), np.asarray(mix),
        np.asarray(bias))


def test_convnet_lift_learner_step_matches(small_tree):
    cfg, net, (_, rollout_jit, learn_jit, _), state = _lift_fns(small_tree,
                                                                CONV)
    state, traj = rollout_jit(state)
    assert traj.obs.shape[2] == LIFT["channels"] + 1
    new, metrics = learn_jit(state, traj, jnp.float32(0.5))

    tree = torch_tree(small_tree)
    tnet = torch_convnet(state.variables, A, CONV["channels"], CONV["depth"],
                         in_channels=LIFT["channels"] + 1)
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    tcfg = torch_config.RNaDConfig(
        **CFG, obs_transform=torch_config.ObsTransformConfig(**LIFT))
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(tree),
        torch_trajectory(traj), 0.5, tcfg)
    _assert_metrics_close(tmetrics, metrics)
    for name, want in (("net", new.variables),
                       ("net_target", new.variables_target)):
        got = torch_nets.convnet_to_flax(getattr(tstate, name))
        _assert_tree_close(got, dict(want), 1e-6, name)
    # the learner's statistics moved, and the target's are their EMA
    stats = _flat(new.variables["batch_stats"])
    before = _flat(state.variables["batch_stats"])
    assert all(not np.array_equal(stats[k], before[k]) for k in stats)


@pytest.mark.parametrize("net_cfg", [dict(type="MLP", max_actions=A,
                                          width=WIDTH), CONV])
def test_lifted_rollout_matches(small_tree, net_cfg):
    cfg, net, _, state = _lift_fns(small_tree, net_cfg)
    tf = jax_tf.make_obs_transform(cfg.obs_transform, A)
    key = jax.random.PRNGKey(9)
    actor = lambda vs, obs: jax_nets.apply_eval(net, vs, obs)
    want = jax_engine.rollout_from(
        small_tree, actor, state.variables, key, jnp.ones((B,), jnp.int32),
        small_tree.max_depth, jax_stepping.make_packed_tables(small_tree),
        store_obs=True, obs_dtype=jnp.float32, obs_transform=tf)
    tree = torch_tree(small_tree)
    C = LIFT["channels"] + 1
    if net_cfg["type"] == "MLP":  # lifted inputs: C channels, not 2
        tnet = torch_nets.MLP(A, WIDTH, in_channels=C)
        tnet.load_state_dict(torch_nets.params_from_flax(
            jax.tree.map(np.asarray, state.variables["params"])))
    else:
        tnet = torch_convnet(state.variables, A, CONV["channels"],
                             CONV["depth"], in_channels=C)
    noise = lift_rollout_noise(key, B, A, small_tree.max_transitions,
                               small_tree.max_depth, LIFT["channels"])
    got = torch_engine.rollout_from(
        tree, torch_stepping.make_packed_tables(tree), tnet,
        torch.ones((B,), dtype=torch.int32), noise=noise,
        obs_transform=_torch_lift())
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.obs.shape == (2 * small_tree.max_depth, B, C, A, A)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=0,
                               atol=1e-6)
    for f in ("values", "policy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    # the learner reads the stored observations and their masks
    obs, masks = torch_engine.trajectory_observations(
        torch_stepping.make_packed_tables(tree), got)
    assert obs is got.obs
    _, raw_masks = torch_engine.trajectory_observations(
        torch_stepping.make_packed_tables(tree),
        torch_trajectory(want, keep_obs=False))
    assert torch.equal(masks, raw_masks)


@pytest.mark.parametrize("chunk", [None, 40])
def test_lifted_nashconv_matches(small_tree, chunk):
    kw = {} if chunk is None else dict(nashconv_chunk_nodes=chunk)
    _, net, (*_, nashconv_fn), state = _lift_fns(small_tree, CONV, **kw)
    want = float(nashconv_fn(state.variables).nashconv())
    tree = torch_tree(small_tree)
    assert chunk is None or tree.size > chunk
    tnet = torch_convnet(state.variables, A, CONV["channels"], CONV["depth"],
                         in_channels=LIFT["channels"] + 1)
    got = float(torch_rnad.nashconv(tree, tnet, chunk,
                                    _torch_lift()).nashconv())
    assert abs(got - want) < 1e-5


def test_lift_route_and_errors_match(small_tree):
    tree = torch_tree(small_tree)
    lift = torch_config.ObsTransformConfig(**LIFT)
    mlp = torch_nets.MLP(A, 8, in_channels=LIFT["channels"] + 1)
    assert not torch_engine.uses_fused_turn(mlp, "auto", transform=True)
    assert not torch_engine.uses_fused_turn(mlp, "off", transform=True)
    cases = [
        (dict(rollout_rows_actor="on"), NetConfig(max_actions=A, width=8)),
        (dict(store_rollout_obs=False), NetConfig(max_actions=A, width=8)),
        ({}, NetConfig(type="EquiNet", max_actions=A, channels=4, depth=1,
                       solver_iters=4)),
    ]
    for kw, net_cfg in cases:
        cfg = RNaDConfig(obs_transform=ObsTransformConfig(**LIFT), **kw)
        net = jax_nets.build_net(net_cfg)
        with pytest.raises(ValueError) as want:
            jax_rnad.make_rnad_fns(net, small_tree, cfg)
        tcfg = torch_config.RNaDConfig(obs_transform=lift, **kw)
        with pytest.raises(ValueError) as got:
            torch_rnad.RNaD(tree, tcfg, torch_config.NetConfig(
                **net_cfg.to_json()), device="cpu").initialize()
        assert str(got.value) == str(want.value)
