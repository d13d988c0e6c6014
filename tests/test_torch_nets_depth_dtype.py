"""The deep MLP, the bfloat16 frozen passes and the bfloat16 ConvNet of
rnad_tpu_torch against rnad_tpu.

- The MLP at depth 2 and 3 (``{policy,value}_hidden{i}`` layers): forward
  and ``mlp_head_eval`` from the same flax params within 1e-6, the carrier
  both ways, the rollout route (a deep MLP never reaches kernel K1, whose
  packing has no place for hidden layers) and one fused train step at
  depth 2 with the tolerances of tests/test_torch_rnad.py (weights 1e-6,
  losses rtol 1e-5), also against rnad_tpu's step in its batch-minor
  ``learner_layout="amb"``, which the port's one (T, B, A) path stands in
  for.
- ``frozen_net_dtype="bfloat16"``: one learner step of the float32 MLP
  ("heads": the frozen heads in bfloat16) and of the EquiNet ("off": the
  frozen nets' whole forwards in bfloat16) on rnad_tpu's rollout, with the
  same tolerances (the EquiNet's: 2 lr where the gradient is 0 but for
  rounding, tests/test_torch_rnad_equinet.py).
- The ConvNet with ``compute_dtype="bfloat16"``: forwards in eval and train
  mode within tests/test_torch_bf16.py's ``BF16_ATOL``/``BF16_RTOL`` of
  flax's, and one learner step on rnad_tpu's rollout (weights and BatchNorm
  statistics 1e-6 but 2 lr where the gradient is 0 but for rounding,
  losses rtol 1e-5), against rnad_tpu's step in its default layout and in
  its batch-minor one.

The MLP's and the ConvNet's bfloat16 learner steps are held against
rnad_tpu's step run op by op (``jax.disable_jit``), whose layers round as
flax's ``dtype`` says and as the port does (rnad_tpu's RM+ solve does not
run op by op, so the EquiNet's step is the compiled one).  Compiled on the CPU, XLA keeps the bfloat16 elementwise
chains between two products in float32 (its excess precision), which
parts one bfloat16 ulp from flax's rounding on about half of the outputs:
measured, the MLP's frozen heads move the loss by up to 1.1e-5 relative
and the ConvNet's step by 3.3e-4, while the weights stay within 1e-6.
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
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_torch_bf16 import BF16_ATOL, BF16_RTOL
from tests.test_torch_rnad_equinet import jax_solves
from tests.test_torch_rnad_offpolicy import _flat
from tests.torch_parity import (obs_with_illegal_actions, torch_equinet,
                                torch_trajectory, torch_tree,
                                train_step_noise)

assert jax_solves  # a fixture, used by name below
A, WIDTH, B = 3, 32, 256
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)
CONV = dict(type="ConvNet", max_actions=A, channels=8, depth=2)


def _deep(depth, params=None, dtype="float32"):
    net = torch_nets.build_net(torch_config.NetConfig(
        type="MLP", max_actions=A, width=WIDTH, depth=depth,
        compute_dtype=dtype))
    if params is not None:
        net.load_state_dict(torch_nets.params_from_flax(
            jax.tree.map(np.asarray, params)))
    return net


def _flax_mlp(depth, dtype="float32"):
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH, depth=depth,
                                       compute_dtype=dtype))
    params = jax_nets.init_variables(net, jax.random.PRNGKey(depth), A)
    return net, jax.tree.map(np.asarray, params["params"])


def _assert_close(got, want, atol, loose=None, lr=CFG["lr"]):
    """Leaf by leaf within ``atol``, and within 2 lr where ``loose``."""
    got, want = _flat(got), _flat(want)
    loose = _flat(loose) if loose is not None else {}
    assert set(got) == set(want)
    for k, w in want.items():
        tol = np.full(w.shape, atol, np.float32)
        if k in loose:
            tol = np.where(loose[k], 2 * lr, tol)
        assert (np.abs(got[k] - w) <= tol).all(), (k, np.abs(got[k] - w).max())


def _zero_gradients(learn_loss_args, params):
    """True where rnad_tpu's gradient of the loss is numerically 0 (below
    1e-6): Adam with b1=0 scales such a gradient's rounding to a step of up
    to lr, either way, in either package."""
    grads = jax.jit(jax.grad(lambda p: jax_rnad.learn_loss(
        p, *learn_loss_args)[0]))(params)
    return jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-6, grads)


def _assert_metrics_close(tmetrics, metrics):
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the deep MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [2, 3])
def test_deep_mlp_forward_and_heads_match(depth):
    net, params = _flax_mlp(depth)
    assert {f"policy_hidden{i}" for i in range(1, depth)} <= set(params)
    tnet = _deep(depth, params)
    obs = obs_with_illegal_actions(depth, 256, A)
    want = jax_nets.apply_eval(net, {"params": params}, jnp.asarray(obs))
    with torch.no_grad():
        got = tnet(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    for head in ("policy", "value"):
        w = jax_nets.mlp_head_eval(net, params, jnp.asarray(obs), head)
        g = torch_nets.mlp_head_eval(tnet, torch.from_numpy(obs), head)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6, err_msg=head)
    back = torch_nets.params_to_flax(tnet)
    assert set(back) == set(params)
    for name, layer in params.items():
        for leaf, w in layer.items():
            np.testing.assert_array_equal(back[name][leaf], w)
    with pytest.raises(ValueError, match="depth=1"):
        torch_nets.mlp_fused_weights(tnet)


def test_deep_mlp_rolls_out_through_the_generic_turn(small_tree):
    tnet = _deep(2)
    assert not torch_engine.uses_fused_turn(tnet, "auto")
    assert not torch_engine.uses_fused_turn(tnet, "off")
    assert torch_engine.uses_fused_turn(_deep(1), "auto")
    net, _ = _flax_mlp(2)
    packed = jax_stepping.make_packed_tables(small_tree)
    with pytest.raises(ValueError) as want:
        jax_engine.make_mlp_rows_actor(net, packed)
    with pytest.raises(ValueError) as got:
        torch_engine.uses_fused_turn(tnet, "on")
    assert str(got.value) == str(want.value)


def test_deep_mlp_train_step_matches(small_tree):
    _assert_deep_mlp_train_step(small_tree, RNaDConfig(**CFG))


def test_deep_mlp_train_step_matches_rnad_tpus_amb_step(small_tree):
    _assert_deep_mlp_train_step(small_tree,
                                RNaDConfig(**CFG, learner_layout="amb"))


def _assert_deep_mlp_train_step(small_tree, cfg):
    """rnad_tpu's fused step under ``cfg`` against the port's default
    step, from the same weights and noise."""
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH, depth=2))
    step, _, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A, cfg)
    tree = torch_tree(small_tree)
    tstate = torch_rnad.init_train_state(_deep(2, state.variables["params"]),
                                         torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree),
        torch_config.RNaDConfig(**CFG))
    noise = train_step_noise(state.key, B, A, small_tree.max_transitions,
                             small_tree.max_depth)
    new, metrics = step(state, jnp.float32(0.5))
    _, tmetrics = tstep(tstate, 0.5, noise)
    _assert_close(torch_nets.params_to_flax(tstate.net),
                  new.variables["params"], 1e-6)
    _assert_close(torch_nets.params_to_flax(tstate.net_target),
                  new.variables_target["params"], 1e-6)
    _assert_metrics_close(tmetrics, metrics)


# ---------------------------------------------------------------------------
# the bfloat16 frozen passes
# ---------------------------------------------------------------------------


def _learner_pair(small_tree, net_kw, key=0, eager=False, jax_kw=None,
                  **cfg_kw):
    """rnad_tpu's rollout and its learner step under ``cfg_kw`` and
    ``jax_kw`` (op by op where ``eager``) and the port's config under
    ``cfg_kw``; returns (traj, state, new, metrics, tcfg, zero)."""
    kw = dict(CFG, **cfg_kw)
    cfg = RNaDConfig(**kw)
    net = jax_nets.build_net(NetConfig(**net_kw))
    _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    _, _, learn_jit, _ = jax_rnad.make_rnad_fns(
        net, small_tree, RNaDConfig(**kw, **(jax_kw or {})))
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(key), A, cfg)
    _, traj = rollout_jit(state)
    aux = {k: v for k, v in state.variables.items() if k != "params"}
    packed = jax_stepping.make_packed_tables(small_tree)
    zero = _zero_gradients(
        (aux, net, state.variables_target, state.variables_reg,
         state.variables_reg_, packed, traj, jnp.float32(0.5), cfg),
        state.variables["params"])
    if eager:
        with jax.disable_jit():
            new, metrics = learn_jit(state, traj, jnp.float32(0.5))
    else:
        new, metrics = learn_jit(state, traj, jnp.float32(0.5))
    return traj, state, new, metrics, torch_config.RNaDConfig(**kw), zero


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_frozen_heads_learner_step_matches(small_tree, seed):
    """The float32 MLP's frozen heads ("heads") in bfloat16."""
    net_kw = dict(type="MLP", max_actions=A, width=WIDTH)
    traj, state, new, metrics, tcfg, _ = _learner_pair(
        small_tree, net_kw, seed, eager=True, frozen_net_dtype="bfloat16",
        detailed_metrics=True)
    tree = torch_tree(small_tree)
    tstate = torch_rnad.init_train_state(_deep(1, state.variables["params"]),
                                         torch.Generator())
    assert torch_rnad.frozen_dtype(tstate.net, tcfg) == torch.bfloat16
    assert torch_rnad.resolve_fuse_mode(tstate.net, tcfg) == "heads"
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(tree),
        torch_trajectory(traj), 0.5, tcfg)
    _assert_metrics_close(tmetrics, metrics)
    np.testing.assert_allclose(tmetrics["entropy_target"].item(),
                               float(metrics["entropy_target"]), rtol=1e-5)
    _assert_close(torch_nets.params_to_flax(tstate.net),
                  new.variables["params"], 1e-6)
    _assert_close(torch_nets.params_to_flax(tstate.net_target),
                  new.variables_target["params"], 1e-6)
    # the bfloat16 passes moved the loss: float32 frozen heads differ
    f32 = torch_rnad.init_train_state(_deep(1, state.variables["params"]),
                                      torch.Generator())
    f32_cfg = torch_config.RNaDConfig(**CFG)
    f32_metrics = torch_rnad.learn_step(
        f32, torch_stepping.make_packed_tables(tree), torch_trajectory(traj),
        0.5, f32_cfg)
    assert f32_metrics["loss"].item() != tmetrics["loss"].item()


def test_bf16_frozen_equinet_learner_step_matches(small_tree, jax_solves):
    """The EquiNet's frozen nets ("off") in bfloat16, the learner float32."""
    net_kw = dict(type="EquiNet", max_actions=A, channels=16, depth=2,
                  solver_iters=16, solver_prime=True)
    traj, state, new, metrics, tcfg, zero = _learner_pair(
        small_tree, net_kw, frozen_net_dtype="bfloat16", n_discrete=2**16)
    tree = torch_tree(small_tree)
    tnet = torch_equinet(state.variables["params"], A, 16, 2, 16, True)
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    assert torch_rnad.resolve_fuse_mode(tnet, tcfg) == "off"
    assert torch_rnad.obs_storage_dtype(tnet, tcfg) == torch.float32
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(tree),
        torch_trajectory(traj), 0.5, tcfg)
    _assert_metrics_close(tmetrics, metrics)
    _assert_close(torch_nets.params_to_flax(tstate.net),
                  new.variables["params"], 1e-6, zero)
    _assert_close(torch_nets.params_to_flax(tstate.net_target),
                  new.variables_target["params"], 1e-6, zero)


# ---------------------------------------------------------------------------
# the bfloat16 ConvNet
# ---------------------------------------------------------------------------


def _bf16_convnet(variables, channels=CONV["channels"], depth=CONV["depth"]):
    net = torch_nets.build_net(torch_config.NetConfig(
        type="ConvNet", max_actions=A, channels=channels, depth=depth,
        compute_dtype="bfloat16"))
    net.load_state_dict(torch_nets.convnet_from_flax(
        jax.tree.map(np.asarray, dict(variables))))
    return net


@pytest.mark.parametrize("train", [False, True])
def test_bf16_convnet_forward_matches(train):
    out = {}
    for dtype in ("float32", "bfloat16"):
        net = jax_nets.build_net(NetConfig(**CONV, compute_dtype=dtype))
        variables = jax_nets.init_variables(net, jax.random.PRNGKey(5), A)
        obs = obs_with_illegal_actions(11, 128, A)
        mask = (np.arange(128) % 5 != 0).astype(np.float32)
        if train:
            (logits, value), mutated = net.apply(
                variables, jnp.asarray(obs), train=True,
                mask=jnp.asarray(mask), mutable=["batch_stats"])
            want = (logits, value[..., 0])
        else:
            want = jax_nets.apply_eval(net, variables, jnp.asarray(obs))
        tnet = _bf16_convnet(variables)
        if dtype == "float32":
            tnet = torch_nets.ConvNet(A, channels=CONV["channels"],
                                      depth=CONV["depth"])
            tnet.load_state_dict(torch_nets.convnet_from_flax(
                jax.tree.map(np.asarray, dict(variables))))
        with torch.no_grad():
            got = tnet(torch.from_numpy(obs), train=train,
                       mask=torch.from_numpy(mask) if train else None)
        assert all(g.dtype == torch.float32 for g in got)
        want = [np.asarray(w, np.float32) for w in want]
        # float32 in train mode: tests/test_torch_convnet.py's 1e-5
        tol = (dict(rtol=BF16_RTOL, atol=BF16_ATOL) if dtype == "bfloat16"
               else dict(rtol=1e-5, atol=1e-5))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **tol)
        if train:
            stats = torch_nets.convnet_to_flax(tnet)["batch_stats"]
            _assert_close(stats, mutated["batch_stats"], 1e-6)
        out[dtype] = want
    gap = max(np.abs(b - f).max() for b, f in zip(out["bfloat16"],
                                                   out["float32"]))
    assert gap > 100 * BF16_ATOL, gap


def test_bf16_convnet_learner_step_matches(small_tree):
    _assert_bf16_convnet_learner_step(small_tree)


def test_bf16_convnet_learner_step_matches_rnad_tpus_amb_step(small_tree):
    _assert_bf16_convnet_learner_step(small_tree,
                                      dict(learner_layout="amb"))


def _assert_bf16_convnet_learner_step(small_tree, jax_kw=None):
    net_kw = dict(CONV, compute_dtype="bfloat16")
    traj, state, new, metrics, tcfg, zero = _learner_pair(
        small_tree, net_kw, 3, eager=True, jax_kw=jax_kw)
    tree = torch_tree(small_tree)
    tnet = _bf16_convnet(state.variables)
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(tree),
        torch_trajectory(traj), 0.5, tcfg)
    _assert_metrics_close(tmetrics, metrics)
    for name, want in (("net", new.variables),
                       ("net_target", new.variables_target)):
        got = torch_nets.convnet_to_flax(getattr(tstate, name))
        _assert_close(got, dict(want), 1e-6,
                      {"params": zero, "batch_stats": {}})
