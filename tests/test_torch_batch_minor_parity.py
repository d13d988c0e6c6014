"""The port's one learner layout, (T, B, A), against rnad_tpu's batch-minor
layout (``learner_layout="amb"``), which the port does not run: rnad_tpu
keeps it for the TPU's 128-lane tile and computes the same values in it.

- The port's masked policies, ``process_policy``, ``v_trace_both`` and the
  two losses with their gradients against rnad_tpu's ``*_minor`` functions
  on the same inputs, transposed to (T, A, B) (tests/test_vtrace_minor.py's
  inputs, drawn from a seed through numpy), at A = 3 and 5, within
  tests/test_torch_vtrace.py's tolerance (rtol 1e-5, atol 1e-6).
- One port learner step on rnad_tpu's rollout against rnad_tpu's "amb"
  step at tests/test_torch_learner_variants.py's tolerances: losses rtol
  1e-5, weights and target rtol 2e-6 and atol 1e-7 but 2 lr where
  rnad_tpu's gradient is 0 but for rounding; the diagnostics rtol 1e-5
  and atol 1e-6, as tests/test_torch_rnad_equinet.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.learn import vtrace as jax_vtrace
from rnad_tpu.models import common as jax_common
from rnad_tpu_torch.learn import vtrace
from rnad_tpu_torch.models import common
from tests.test_torch_learner_variants import (_port_step, assert_close,
                                               jax_learner_step)

T_, B_ = 6, 17
TOL = dict(rtol=1e-5, atol=1e-6)


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
    """A (..., B, A) array as rnad_tpu's batch-minor (..., A, B)."""
    return jnp.swapaxes(jnp.asarray(x), -1, -2)


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def _near_minor(got, want):
    """The port's (..., B, A) result against rnad_tpu's (..., A, B)."""
    np.testing.assert_allclose(np.swapaxes(got.detach().numpy(), -1, -2),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("A_", [3, 5])
def test_v_trace_both_matches_rnad_tpus_minor(A_):
    n = _inputs(0, A=A_)
    d = _t(n)
    vt, played, out = vtrace.v_trace_both(
        d["v"][..., None], d["valid"], d["player_id"], d["mu"], d["pi"],
        d["log_pi_reg"], d["actions_oh"], d["reward"], eta=0.2)
    want = jax_vtrace.v_trace_both_minor(
        jnp.asarray(n["v"]), jnp.asarray(n["valid"]),
        jnp.asarray(n["player_id"]), _amb(n["mu"]), _amb(n["pi"]),
        _amb(n["log_pi_reg"]), _amb(n["actions_oh"]), jnp.asarray(n["reward"]),
        eta=0.2)
    np.testing.assert_allclose(vt[..., 0].numpy(), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_array_equal(played.numpy(), np.asarray(want[1]))
    _near_minor(out, want[2])


@pytest.mark.parametrize("A_", [3, 5])
def test_process_policy_matches_rnad_tpus_minor(A_):
    n = _inputs(1, T=4, B=33, A=A_)
    d = _t(n)
    got = vtrace.process_policy(d["pi"], d["legal"], 32, 0.03)
    _near_minor(got, jax_vtrace.process_policy_minor(
        _amb(n["pi"]), _amb(n["legal"]), 32, 0.03))


@pytest.mark.parametrize("A_", [3, 5])
def test_masked_policy_matches_rnad_tpus_minor(A_):
    n = _inputs(2, A=A_)
    d = _t(n)
    jl, jg = _amb(n["logits"]), _amb(n["legal"])
    _near_minor(common.masked_policy(d["logits"], d["legal"]),
                jax_common.masked_policy_minor(jl, jg))
    _near_minor(common.masked_log_policy(d["logits"], d["legal"]),
                jax_common.masked_log_policy_minor(jl, jg))


@pytest.mark.parametrize("A_", [3, 5])
def test_losses_with_grads_match_rnad_tpus_minor(A_):
    n = _inputs(3, A=A_)
    d = _t(n)
    vt, played, out = vtrace.v_trace_both(
        d["v"][..., None], d["valid"], d["player_id"], d["mu"], d["pi"],
        d["log_pi_reg"], d["actions_oh"], d["reward"], eta=0.2)

    def port_loss(logits):
        v = d["v"][..., None]
        pi = common.masked_policy(logits, d["legal"])
        is_vec = torch.ones_like(d["valid"])[..., None]
        lv = vtrace.get_loss_v([v, v], list(vt), list(played))
        ln = vtrace.get_loss_nerd([logits, logits], [pi, pi], list(out),
                                  d["valid"], d["player_id"], d["legal"],
                                  [is_vec, is_vec], clip=1e3, threshold=2.0)
        return lv + ln

    x = d["logits"].clone().requires_grad_(True)
    loss = port_loss(x)
    grad = torch.autograd.grad(loss, x)[0]

    j = {k: jnp.asarray(v) for k, v in n.items()}
    jvt = [jnp.asarray(t[..., 0].numpy()) for t in vt]
    jhp = [jnp.asarray(t.numpy()) for t in played]
    jout = [_amb(t.numpy()) for t in out]

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
    np.testing.assert_allclose(loss.item(), float(l_j), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_j), **TOL)


def test_amb_learner_step_matches_rnad_tpu(small_tree):
    traj, state, new, metrics, zero = jax_learner_step(
        small_tree, learner_layout="amb")
    tstate, tmetrics = _port_step(small_tree, traj, state)
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        tol = (dict(rtol=1e-5) if k in ("loss", "loss_v", "loss_nerd")
               else TOL)
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   err_msg=k, **tol)
    assert_close(tstate.net, new.variables["params"], zero)
    assert_close(tstate.net_target, new.variables_target["params"], zero)
