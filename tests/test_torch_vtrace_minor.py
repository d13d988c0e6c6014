"""The batch-minor learner layout (``learner_layout="amb"``) of
rnad_tpu_torch against its (T, B, A) layout and against rnad_tpu.

- Each minor function (the masked policies, ``v_trace_both_minor``,
  ``process_policy_minor``, the two losses and their gradients) is bitwise
  the port's (T, B, A) function after the permute, and within 1e-6
  (relative and absolute) of rnad_tpu's minor function on the same inputs (tests/test_vtrace_minor.py's
  four cases, inputs drawn from a seed through numpy).
- One "amb" learner step on rnad_tpu's rollout against rnad_tpu's "amb"
  step: weights rtol 1e-5 and atol 1e-7 (2 lr where the gradient is 0 but
  for rounding: Adam with b1 = 0 steps such a weight by up to lr either
  way), metrics rtol 1e-4 (tests/test_rnad.py::
  test_learner_layout_bit_exact); three port steps in each layout bitwise
  equal on the CPU.
- ``resolve_learner_layout``'s errors read as rnad_tpu's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.learn import vtrace as jax_vtrace
from rnad_tpu.models import common as jax_common
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.learn import vtrace
from rnad_tpu_torch.models import common
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_torch_learner_variants import (A, CFG, assert_close,
                                               jax_learner_step, port_state)
from tests.torch_parity import torch_trajectory, torch_tree

T_, B_ = 6, 17


def _inputs(seed, T=T_, B=B_, A=3):
    """tests/test_vtrace_minor.py's inputs, drawn through numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    legal = f32(rng.random((T, B, A)) > 0.25)
    legal[..., 0] = 1.0
    t = torch.from_numpy
    masked = lambda x: common.masked_policy(t(f32(x)), t(legal)).numpy()
    logits = f32(rng.normal(size=(T, B, A)))
    mu = masked(rng.normal(size=(T, B, A)))
    pi = masked(logits)
    log_pi_reg = common.masked_log_policy(
        t(f32(rng.normal(size=(T, B, A)))), t(legal)).numpy()
    # an action drawn from mu among the legal ones
    u = rng.random((T, B, 1))
    actions = np.minimum((np.cumsum(mu, -1) < u).sum(-1), A - 1)
    actions = np.where(legal[np.arange(T)[:, None], np.arange(B),
                             actions] > 0, actions, 0)
    actions_oh = f32(np.eye(A)[actions])
    valid = f32(rng.random((T, B)) > 0.2)
    player_id = (np.arange(T, dtype=np.int32) % 2)[:, None] * np.ones(
        (T, B), np.int32)
    reward = f32(rng.normal(size=(T, B))) * valid
    v = f32(rng.normal(size=(T, B)))
    return dict(logits=logits, legal=legal, mu=mu, pi=pi,
                log_pi_reg=log_pi_reg, actions_oh=actions_oh, valid=valid,
                player_id=player_id, reward=reward, v=v)


def _amb(x):
    return x.transpose(-1, -2) if isinstance(x, torch.Tensor) else \
        np.swapaxes(x, -1, -2).copy()


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _equal(a, b):
    assert torch.equal(a, b), float((a - b).abs().max())


def _near_jax(got, want):
    """Within 1e-6, relative and absolute: the learning outputs reach ~20
    (1 / mu), where one float32 ulp is 1.9e-6."""
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_v_trace_both_minor_bit_exact():
    n = _inputs(0)
    d, j = _t(n), _j(n)
    vt, played, out = vtrace.v_trace_both(
        d["v"][..., None], d["valid"], d["player_id"], d["mu"], d["pi"],
        d["log_pi_reg"], d["actions_oh"], d["reward"], eta=0.2)
    args_m = (d["v"], d["valid"], d["player_id"], _amb(d["mu"]),
              _amb(d["pi"]), _amb(d["log_pi_reg"]), _amb(d["actions_oh"]),
              d["reward"])
    vt_m, played_m, out_m = vtrace.v_trace_both_minor(*args_m, eta=0.2)
    _equal(vt[..., 0], vt_m)
    _equal(played, played_m)
    _equal(_amb(out), out_m)
    want = jax_vtrace.v_trace_both_minor(
        j["v"], j["valid"], j["player_id"], _amb(j["mu"]), _amb(j["pi"]),
        _amb(j["log_pi_reg"]), _amb(j["actions_oh"]), j["reward"], eta=0.2)
    for g, w in zip((vt_m, played_m, out_m), want):
        _near_jax(g, w)


@pytest.mark.parametrize("A_", [3, 5])
def test_process_policy_minor_bit_exact(A_):
    n = _inputs(1, T=4, B=33, A=A_)
    d = _t(n)
    ref = vtrace.process_policy(d["pi"], d["legal"], 32, 0.03)
    minor = vtrace.process_policy_minor(_amb(d["pi"]), _amb(d["legal"]),
                                        32, 0.03)
    _equal(_amb(ref), minor)
    want = jax_vtrace.process_policy_minor(
        jnp.asarray(_amb(n["pi"])), jnp.asarray(_amb(n["legal"])), 32, 0.03)
    _near_jax(minor, want)


@pytest.mark.parametrize("A_", [3, 5])
def test_masked_policy_minor_bit_exact(A_):
    n = _inputs(2, A=A_)
    d = _t(n)
    p = common.masked_policy(d["logits"], d["legal"])
    lp = common.masked_log_policy(d["logits"], d["legal"])
    lm, gm = _amb(d["logits"]).contiguous(), _amb(d["legal"]).contiguous()
    p_m = common.masked_policy_minor(lm, gm)
    lp_m = common.masked_log_policy_minor(lm, gm)
    _equal(_amb(p), p_m)
    _equal(_amb(lp), lp_m)
    jl, jg = jnp.asarray(_amb(n["logits"])), jnp.asarray(_amb(n["legal"]))
    _near_jax(p_m, jax_common.masked_policy_minor(jl, jg))
    _near_jax(lp_m, jax_common.masked_log_policy_minor(jl, jg))


def test_losses_minor_bit_exact_with_grads():
    n = _inputs(3)
    d = _t(n)
    vt, played, out = vtrace.v_trace_both(
        d["v"][..., None], d["valid"], d["player_id"], d["mu"], d["pi"],
        d["log_pi_reg"], d["actions_oh"], d["reward"], eta=0.2)
    vt_l, hp_l, out_l = list(vt), list(played), list(out)

    def loss_ref(logits):
        v = d["v"][..., None]
        pi = common.masked_policy(logits, d["legal"])
        is_vec = torch.ones_like(d["valid"])[..., None]
        lv = vtrace.get_loss_v([v, v], vt_l, hp_l)
        ln = vtrace.get_loss_nerd([logits, logits], [pi, pi], out_l,
                                  d["valid"], d["player_id"], d["legal"],
                                  [is_vec, is_vec], clip=1e3, threshold=2.0)
        return lv + ln

    def loss_minor(logits):
        logits_m = _amb(logits).contiguous()
        legal_m = _amb(d["legal"]).contiguous()
        pi_m = common.masked_policy_minor(logits_m, legal_m)
        lv = vtrace.get_loss_v_minor([d["v"], d["v"]],
                                     [x[..., 0] for x in vt_l], hp_l)
        ln = vtrace.get_loss_nerd_minor(
            [logits_m, logits_m], [pi_m, pi_m],
            [_amb(x).contiguous() for x in out_l], d["valid"],
            d["player_id"], legal_m, [torch.ones_like(d["valid"])] * 2,
            clip=1e3, threshold=2.0)
        return lv + ln

    got = {}
    for name, fn in (("ref", loss_ref), ("minor", loss_minor)):
        x = d["logits"].clone().requires_grad_(True)
        loss = fn(x)
        got[name] = (loss.detach(), torch.autograd.grad(loss, x)[0])
    _equal(got["ref"][0], got["minor"][0])
    _equal(got["ref"][1], got["minor"][1])

    j = _j(n)
    jvt = [jnp.asarray(x[..., 0].numpy()) for x in vt_l]
    jhp = [jnp.asarray(x.numpy()) for x in hp_l]
    jout = [jnp.asarray(_amb(x.numpy())) for x in out_l]

    def jax_minor(logits):
        logits_m = jnp.moveaxis(logits, -1, -2)
        legal_m = jnp.moveaxis(j["legal"], -1, -2)
        pi_m = jax_common.masked_policy_minor(logits_m, legal_m)
        lv = jax_vtrace.get_loss_v_minor([j["v"], j["v"]], jvt, jhp)
        ln = jax_vtrace.get_loss_nerd_minor(
            [logits_m, logits_m], [pi_m, pi_m], jout, j["valid"],
            j["player_id"], legal_m, [jnp.ones_like(j["valid"])] * 2,
            clip=1e3, threshold=2.0)
        return lv + ln

    l_j, g_j = jax.value_and_grad(jax_minor)(j["logits"])
    _near_jax(got["minor"][0], l_j)
    _near_jax(got["minor"][1], g_j)


def test_amb_learner_step_matches_rnad_tpu(small_tree):
    traj, state, new, metrics, zero = jax_learner_step(
        small_tree, learner_layout="amb")
    tcfg = torch_config.RNaDConfig(**CFG, learner_layout="amb")
    tstate = port_state(state)
    tmetrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(torch_tree(small_tree)),
        torch_trajectory(traj), 0.5, tcfg)
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert_close(tstate.net, new.variables["params"], zero, rtol=1e-5,
                 atol=1e-7)
    assert_close(tstate.net_target, new.variables_target["params"], zero,
                 rtol=1e-5, atol=1e-7)


def test_amb_steps_equal_bma_steps(small_tree):
    """Three port train steps in each layout, from one state and one
    noise stream: bitwise equal weights, target and moments."""
    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    net = torch_nets.build_net(torch_config.NetConfig(max_actions=A,
                                                      width=16),
                               torch.Generator().manual_seed(5))
    states = []
    for layout in ("bma", "amb"):
        state = torch_rnad.init_train_state(
            copy.deepcopy(net), torch.Generator().manual_seed(6))
        step = torch_rnad.make_train_step(tree, packed, torch_config.
                                          RNaDConfig(**CFG,
                                                     learner_layout=layout))
        for _ in range(3):
            step(state, 0.5)
        states.append(state)
    a, b = states
    for name in ("net", "net_target"):
        for p, q in zip(getattr(a, name).parameters(),
                        getattr(b, name).parameters()):
            assert torch.equal(p, q), name
    for p, q in zip(a.opt.mu + a.opt.nu, b.opt.mu + b.opt.nu):
        assert torch.equal(p, q)


@pytest.mark.parametrize("kw,assoc,max_actions", [
    (dict(learner_layout="amb"), True, 3),
    (dict(learner_layout="amb"), False, 20),
    (dict(learner_layout="diagonal"), False, 3),
])
def test_layout_errors_match_jax(kw, assoc, max_actions):
    with pytest.raises(ValueError) as want:
        jax_rnad.resolve_learner_layout(RNaDConfig(**kw), assoc,
                                        max_actions=max_actions)
    with pytest.raises(ValueError) as got:
        torch_rnad.resolve_learner_layout(torch_config.RNaDConfig(**kw),
                                          assoc, max_actions=max_actions)
    assert str(got.value) == str(want.value)


def test_layout_resolution():
    resolve = lambda mode, assoc=False, a=3: torch_rnad.resolve_learner_layout(
        torch_config.RNaDConfig(learner_layout=mode), assoc, a)
    assert resolve("amb") is True
    assert resolve("bma") is False
    assert resolve("auto") is False  # off a TPU, as rnad_tpu resolves it
    assert resolve("auto", a=20) is False
    assert resolve("auto", assoc=True) is False
    with pytest.raises(NotImplementedError, match="A <= 16"):
        vtrace.process_policy_minor(torch.ones(2, 17, 4), torch.ones(2, 17, 4),
                                    32)
