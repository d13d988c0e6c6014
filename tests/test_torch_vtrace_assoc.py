"""rnad_tpu_torch.learn.vtrace_assoc against rnad_tpu.learn.vtrace_assoc.

On the batches of tests/test_vtrace_assoc.py (random trajectories with
ragged lengths, random legal actions and policies), within rnad_tpu's own
tolerances: the port's suffix scan equals a sequential loop (rtol 1e-5,
atol 1e-6); ``v_trace_assoc`` and ``v_trace_both_assoc`` equal rnad_tpu's
within 2e-5, and within 1e-4 on deep (T = 64) trajectories with arbitrary
player interleavings; extreme IS ratios stay finite; and one learner step
with ``vtrace_mode="associative"`` equals rnad_tpu's associative step
(weights within atol 1e-6, losses within rtol 1e-5, as
tests/test_torch_rnad.py) and the port's scan step within rnad_tpu's
tolerances for that comparison (losses rtol 2e-5, atol 2e-6; weights rtol
1e-4, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.learn import vtrace as jax_vtrace
from rnad_tpu.learn import vtrace_assoc as jax_assoc
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.learn import vtrace as torch_vtrace
from rnad_tpu_torch.learn import vtrace_assoc as torch_assoc
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_vtrace_assoc import make_batch
from tests.torch_parity import torch_mlp, torch_trajectory, torch_tree

KW = dict(lambda_=1.0, c=1.0, rho=1.0, gamma=1.0)


@pytest.mark.parametrize("T", [1, 2, 7, 13, 64])
def test_affine_suffix_scan_matches_sequential(T):
    rng = np.random.default_rng(T)
    a = rng.normal(size=(T, 5)).astype(np.float32)
    b = rng.normal(size=(T, 5)).astype(np.float32)
    init = 0.7
    carry, ref = np.full((5,), init, np.float64), []
    for t in reversed(range(T)):
        carry = a[t] + b[t] * carry
        ref.append(carry)
    ref = np.stack(ref[::-1])
    got, got_next = torch_assoc.affine_suffix_scan(
        torch.from_numpy(a), torch.from_numpy(b), init)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_next[:-1].numpy(), ref[1:], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_next[-1].numpy(),
                                  np.full((5,), init, np.float32))


def _args(d, player, mu=None):
    """(jax args, torch args) of one player's v-trace on batch ``d``."""
    mu = d["mu"] if mu is None else mu
    names = ("v", "valid", "player_id")
    jargs = [jnp.asarray(d[k]) for k in names] + [
        jnp.asarray(mu), jnp.asarray(d["pi"]), jnp.asarray(d["log_pi_reg"]),
        jax_vtrace.player_others(jnp.asarray(d["player_id"]),
                                 jnp.asarray(d["valid"]), player),
        jnp.asarray(d["actions_oh"]), jnp.asarray(d["reward"]), player]
    t = lambda x: torch.from_numpy(np.array(x))
    targs = [t(d["v"]), t(d["valid"]), t(d["player_id"]), t(mu), t(d["pi"]),
             t(d["log_pi_reg"]),
             torch_vtrace.player_others(t(d["player_id"]), t(d["valid"]),
                                        player),
             t(d["actions_oh"]), t(d["reward"]), player]
    return jargs, targs


def _assert_outputs_close(got, want, tol):
    vt, hp, lo = got
    np.testing.assert_allclose(vt.numpy(), np.asarray(want[0]), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(lo.numpy(), np.asarray(want[2]), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("player", [0, 1])
@pytest.mark.parametrize("eta", [0.0, 0.2, 1.0])
def test_v_trace_assoc_matches(seed, player, eta):
    jargs, targs = _args(make_batch(seed), player)
    want = jax_assoc.v_trace_assoc(*jargs, eta=eta, **KW)
    got = torch_assoc.v_trace_assoc(*targs, eta=eta, **KW)
    _assert_outputs_close(got, want, 2e-5)
    # and the port's sequential form
    _assert_outputs_close(torch_vtrace.v_trace(*targs, eta=eta, **KW),
                          want, 2e-5)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("alternate", [True, False])
def test_v_trace_assoc_deep_trajectories(seed, alternate):
    d = make_batch(seed, T=64, B=5, alternate=alternate)
    for player in (0, 1):
        jargs, targs = _args(d, player)
        want = jax_assoc.v_trace_assoc(*jargs, eta=0.2, **KW)
        got = torch_assoc.v_trace_assoc(*targs, eta=0.2, **KW)
        _assert_outputs_close(got, want, 1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_v_trace_both_assoc_matches(eta):
    d = make_batch(7, T=12, B=6)
    jargs, targs = _args(d, 0)
    jshared = jargs[:6] + jargs[7:9]
    tshared = targs[:6] + targs[7:9]
    want = jax_assoc.v_trace_both_assoc(*jshared, eta=eta, **KW)
    got = torch_assoc.v_trace_both_assoc(*tshared, eta=eta, **KW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_v_trace_assoc_extreme_is_ratios_stay_finite():
    d = make_batch(11, T=16, B=4)
    mu = np.asarray(d["mu"]).copy()
    mu[np.asarray(d["actions_oh"]).astype(bool)] = 1e-30
    mu = mu / mu.sum(-1, keepdims=True)
    for player in (0, 1):
        jargs, targs = _args(d, player, mu)
        vt, _, lo = torch_assoc.v_trace_assoc(*targs, eta=0.2)
        assert torch.isfinite(vt).all() and torch.isfinite(lo).all()
        want = jax_assoc.v_trace_assoc(*jargs, eta=0.2)
        np.testing.assert_allclose(vt.numpy(), np.asarray(want[0]),
                                   rtol=2e-5, atol=2e-5)


A, WIDTH, B = 3, 32, 64
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)


def test_associative_learner_step_matches(small_tree):
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    cfg = RNaDConfig(**CFG, vtrace_mode="associative")
    _, rollout_jit, learn_jit, _ = jax_rnad.make_rnad_fns(net, small_tree,
                                                          cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A, cfg)
    state, traj = rollout_jit(state)
    new, metrics = learn_jit(state, traj, jnp.float32(0.5))

    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    out = {}
    for mode in ("associative", "scan"):
        tstate = torch_rnad.init_train_state(
            torch_mlp(state.variables["params"], A, WIDTH),
            torch.Generator())
        tmetrics = torch_rnad.learn_step(
            tstate, packed, torch_trajectory(traj, keep_obs=False), 0.5,
            torch_config.RNaDConfig(**CFG, vtrace_mode=mode))
        out[mode] = (tmetrics, torch_nets.params_to_flax(tstate.net))
    tmetrics, params = out["associative"]
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    want = new.variables["params"]
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(params[layer][leaf],
                                       np.asarray(want[layer][leaf]),
                                       rtol=0, atol=1e-6)
    smetrics, sparams = out["scan"]
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), smetrics[k].item(),
                                   rtol=2e-5, atol=2e-6)
    for layer in sparams:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(params[layer][leaf],
                                       sparams[layer][leaf], rtol=1e-4,
                                       atol=1e-6)


def test_associative_mode_checks():
    # rnad_tpu refuses its batch-minor layout with the associative
    # v-trace; the port runs neither "amb" nor any other batch-minor path
    with pytest.raises(NotImplementedError, match="learner_layout"):
        torch_rnad.check_supported(
            torch_config.RNaDConfig(vtrace_mode="associative",
                                    learner_layout="amb"),
            torch_config.NetConfig())
    with pytest.raises(ValueError, match="unknown vtrace_mode"):
        torch_rnad.check_supported(
            torch_config.RNaDConfig(vtrace_mode="parallel"),
            torch_config.NetConfig())
