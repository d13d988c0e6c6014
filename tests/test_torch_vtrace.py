"""rnad_tpu_torch.learn.vtrace against rnad_tpu.learn.vtrace: values and
gradients over 3 seeds x eta in {0, 0.2, 1}, on inputs made with numpy, in
float32 within rtol 1e-5, atol 1e-6 (elementwise op order is the same;
only library exp/log rounding differs)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.learn import vtrace as jax_vtrace
from rnad_tpu_torch.learn import vtrace as torch_vtrace

SEEDS = (0, 1, 2)
ETAS = (0.0, 0.2, 1.0)
TOL = dict(rtol=1e-5, atol=1e-6)


def _softmax(x, legal):
    x = np.where(legal > 0, x, -np.inf)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(seed, T=8, B=64, A=3):
    rng = np.random.default_rng(seed)
    legal = (rng.random((T, B, A)) < 0.75).astype(np.float32)
    legal[..., 0] = 1.0
    lengths = rng.integers(1, T + 1, B)
    valid = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    mu = _softmax(rng.normal(size=(T, B, A)), legal)
    logits = rng.normal(size=(T, B, A)).astype(np.float32) * 2
    # every fourth lane has exactly tied legal logits (process_policy ties)
    logits[:, ::4] = 0.5
    pi = _softmax(logits, legal)
    log_pi_reg = np.where(legal > 0, np.log(np.maximum(
        _softmax(rng.normal(size=(T, B, A)), legal), 1e-30)), 0.0)
    actions = np.array([[rng.choice(A, p=mu[t, b]) for b in range(B)]
                        for t in range(T)])
    actions_oh = np.eye(A, dtype=np.float32)[actions]
    player_id = np.broadcast_to((np.arange(T) % 2)[:, None],
                                (T, B)).astype(np.int32).copy()
    reward = np.zeros((T, B), np.float32)
    last = lengths - 1
    reward[last, np.arange(B)] = rng.choice([-1.0, 1.0], B) * (last % 2 == 1)
    v = rng.normal(size=(T, B, 1)).astype(np.float32)
    return dict(v=v, valid=valid, player_id=player_id, mu=mu, pi=pi,
                logits=logits, log_pi_reg=log_pi_reg.astype(np.float32),
                actions_oh=actions_oh, reward=reward, legal=legal)


def _vtrace_args(d, lib):
    conv = jnp.asarray if lib is jax_vtrace else torch.from_numpy
    keys = ("v", "valid", "player_id", "mu", "pi", "log_pi_reg",
            "actions_oh", "reward")
    return [conv(d[k]) for k in keys]


@functools.partial(jax.jit, static_argnames=("eta",))
def _jax_v_trace_both(*args, eta):
    return jax_vtrace.v_trace_both(*args, eta=eta)


def _jax_targets(d, eta):
    return _jax_v_trace_both(*_vtrace_args(d, jax_vtrace), eta=eta)


@jax.jit
def _jax_loss_v(v, vt0, vt1, played0, played1):
    return jax_vtrace.get_loss_v([v, v], [vt0, vt1], [played0, played1])


@jax.jit
def _jax_loss_nerd(logits, pi_p, q0, q1, valid, player_id, legal, is_vec):
    return jax_vtrace.get_loss_nerd(
        [logits, logits], [pi_p, pi_p], [q0, q1], valid, player_id, legal,
        [is_vec, is_vec], clip=1e3, threshold=2.0)


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_v_trace_both(seed, eta):
    d = _inputs(seed)
    want = _jax_targets(d, eta)
    got = torch_vtrace.v_trace_both(*_vtrace_args(d, torch_vtrace), eta=eta)
    for name, w, g in zip(("v_target", "has_played", "learning_output"),
                          want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # single-player form agrees with the stacked one
    p_others = torch_vtrace.player_others(torch.from_numpy(d["player_id"]),
                                          torch.from_numpy(d["valid"]), 1)
    args = _vtrace_args(d, torch_vtrace)
    one = torch_vtrace.v_trace(*args[:6], p_others, args[6], -args[7], 1,
                               eta=eta)
    for a, b in zip(one, got):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_process_policy(seed, eta):
    d = _inputs(seed, A=5)
    n_disc = (32, 16, 8)[SEEDS.index(seed)]
    eps = 0.03 + 0.1 * eta  # vary the threshold across the grid
    want = jax_vtrace.process_policy(jnp.asarray(d["pi"]),
                                     jnp.asarray(d["legal"]), n_disc, eps)
    got = torch_vtrace.process_policy(torch.from_numpy(d["pi"]),
                                      torch.from_numpy(d["legal"]), n_disc,
                                      eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_get_loss_v_value_and_grad(seed, eta):
    d = _inputs(seed)
    v_t2, played2, _ = _jax_targets(d, eta)
    vt = [np.array(v_t2[p]) for p in range(2)]
    played = [np.array(played2[p]) for p in range(2)]
    want, want_grad = jax.value_and_grad(_jax_loss_v)(
        jnp.asarray(d["v"]), *vt, *played)
    v = torch.from_numpy(d["v"]).requires_grad_(True)
    got = torch_vtrace.get_loss_v([v, v], [torch.from_numpy(x) for x in vt],
                                  [torch.from_numpy(x) for x in played])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), **TOL)


@pytest.mark.parametrize("eta", ETAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_get_loss_nerd_value_and_grad(seed, eta):
    d = _inputs(seed)
    _, _, out2 = _jax_targets(d, eta)
    q = [np.array(out2[p]) for p in range(2)]
    pi_p = np.array(jax_vtrace.process_policy(
        jnp.asarray(d["pi"]), jnp.asarray(d["legal"]), 32, 0.03))
    is_vec = np.ones(d["valid"].shape + (1,), np.float32)
    want, want_grad = jax.value_and_grad(_jax_loss_nerd)(
        jnp.asarray(d["logits"]), pi_p, *q, d["valid"], d["player_id"],
        d["legal"], is_vec)
    logits = torch.from_numpy(d["logits"]).requires_grad_(True)
    got = torch_vtrace.get_loss_nerd(
        [logits, logits], [torch.from_numpy(pi_p)] * 2,
        [torch.from_numpy(x) for x in q], torch.from_numpy(d["valid"]),
        torch.from_numpy(d["player_id"]), torch.from_numpy(d["legal"]),
        [torch.from_numpy(is_vec)] * 2, clip=1e3, threshold=2.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(want_grad),
                               **TOL)
