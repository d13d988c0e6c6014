"""compute_dtype="bfloat16" and the cosine learning rate of rnad_tpu_torch
against rnad_tpu.

bfloat16 follows flax's ``dtype``: float32 parameters, each layer's input,
kernel and bias cast to bfloat16, outputs float32.  From the same weights
(and, for the EquiNet, the same solver features) the port's bfloat16
forwards agree with rnad_tpu's within ``BF16_ATOL`` (measured: equal), and
both differ from their float32 forwards by far more, so the cast does
happen.  One bfloat16 EquiNet train step agrees as the float32 step does in
tests/test_torch_rnad_equinet.py (weights within 1e-6 but 2 lr where the
gradient is 0 but for rounding).  The cosine learning rate is within one
float32 ulp of ``optax.cosine_decay_schedule`` (the cosine is rounded from
float64 here, XLA's own float32 cosine there) and equal to it from
``lr_decay_steps`` on; three cosine train steps agree with rnad_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_torch_rnad_equinet import (CFG, _assert_params_close,
                                           _zero_gradients, jax_solves)
from tests.torch_parity import (obs_with_illegal_actions, torch_mlp,
                                torch_tree, train_step_noise)

assert jax_solves  # a fixture, used by name below
A = 3
BF16_ATOL = 1e-6
BF16_RTOL = 2.4e-7  # two float32 ulps: the primed gates add log x in f32
NETS = {
    "mlp": dict(type="MLP", max_actions=A, width=32),
    "equinet": dict(type="EquiNet", max_actions=A, channels=16, depth=2),
    "equinet_primed": dict(type="EquiNet", max_actions=A, channels=16,
                           depth=2, solver_iters=16, solver_prime=True),
}


def _torch_net(kw, dtype, params):
    net = torch_nets.build_net(torch_config.NetConfig(**kw,
                                                      compute_dtype=dtype))
    net.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, params)))
    return net


def _params(net, kw):
    """Initial flax params; the primed heads (zero at init) get random
    weights, so that the tower reaches the outputs."""
    params = jax.tree.map(np.asarray, jax_nets.init_variables(
        net, jax.random.PRNGKey(0), A)["params"])
    if kw.get("solver_prime"):
        rng = np.random.default_rng(1)
        for head in ("policy", "value"):
            params[head] = {k: (rng.normal(size=v.shape) * 0.3)
                            .astype(np.float32)
                            for k, v in params[head].items()}
    return params


@pytest.mark.parametrize("kind", sorted(NETS))
def test_bf16_forward_matches(kind):
    kw = NETS[kind]
    obs = obs_with_illegal_actions(7, 512, A)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jnet = jax_nets.build_net(NetConfig(**kw, compute_dtype=dtype))
        params = _params(jnet, kw)
        apply_kw = {}
        if kw.get("solver_iters"):
            apply_kw["solver_feats"] = jax_nets.equinet_solver_features(
                jnet, jnp.asarray(obs))
        want = jax_nets.apply_eval(jnet, {"params": params},
                                   jnp.asarray(obs), **apply_kw)
        tnet = _torch_net(kw, dtype, params)
        feats = apply_kw.get("solver_feats")
        if feats is not None:
            feats = tuple(torch.from_numpy(np.array(f)) for f in feats)
        with torch.no_grad():
            got = tnet(torch.from_numpy(obs), feats)
        assert all(g.dtype == torch.float32 for g in got)
        out[dtype] = [np.asarray(w) for w in want], [g.numpy() for g in got]
        for g, w in zip(*out[dtype][::-1]):
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)
    (jf, _), (jb, tb) = out["float32"], out["bfloat16"]
    gap = max(np.abs(b - f).max() for b, f in zip(jb, jf))
    assert gap > 100 * BF16_ATOL, gap


def test_bf16_mlp_head_eval_and_route():
    kw = NETS["mlp"]
    jnet = jax_nets.build_net(NetConfig(**kw, compute_dtype="bfloat16"))
    params = _params(jnet, kw)
    tnet = _torch_net(kw, "bfloat16", params)
    obs = obs_with_illegal_actions(8, 64, A)
    for head in ("policy", "value"):
        want = jax_nets.mlp_head_eval(jnet, params, jnp.asarray(obs), head)
        got = torch_nets.mlp_head_eval(tnet, torch.from_numpy(obs), head)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=BF16_ATOL)
    # K1 computes in float32: "auto" rolls a bfloat16 MLP out through the
    # generic turn, "on" raises as make_mlp_rows_actor does
    assert not torch_engine.uses_fused_turn(tnet, "auto")
    with pytest.raises(ValueError, match="float32"):
        torch_engine.uses_fused_turn(tnet, "on")


def _equinet_pair(small_tree, dtype):
    kw = NETS["equinet_primed"]
    cfg = RNaDConfig(**CFG)
    net = jax_nets.build_net(NetConfig(**kw, compute_dtype=dtype))
    train_step, _, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A, cfg)
    tree = torch_tree(small_tree)
    tstate = torch_rnad.init_train_state(
        _torch_net(kw, dtype, state.variables["params"]), torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree),
        torch_config.RNaDConfig(**CFG))
    return (train_step, state, net), (tstep, tstate)


def test_bf16_equinet_train_step_matches(small_tree, jax_solves):
    (step, state, net), (tstep, tstate) = _equinet_pair(small_tree,
                                                        "bfloat16")
    noise = train_step_noise(state.key, CFG["batch_size"], A,
                             small_tree.max_transitions, small_tree.max_depth)
    zero = _zero_gradients(net, small_tree, state, 0.5)
    new, metrics = step(state, jnp.float32(0.5))
    _, tmetrics = tstep(tstate, 0.5, noise)
    _assert_params_close(tstate.net, new.variables["params"], 1e-6, zero)
    _assert_params_close(tstate.net_target, new.variables_target["params"],
                         1e-6, zero)
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("steps,alpha", [(15, 0.1), (18600, 0.1), (7, 0.0),
                                         (1000, 0.05)])
def test_cosine_learning_rate_matches_optax(steps, alpha):
    lr = 5e-5
    cfg = torch_config.RNaDConfig(lr=lr, lr_schedule="cosine",
                                  lr_decay_steps=steps,
                                  lr_final_fraction=alpha)
    schedule = optax.cosine_decay_schedule(lr, steps, alpha=alpha)
    counts = sorted(set(range(0, steps + 3, max(1, steps // 200)))
                    | {steps - 1, steps, steps + 1, steps + 10})
    with jax.disable_jit():
        want = np.array([np.asarray(schedule(jnp.int32(k))) for k in counts])
    got = np.array([torch_rnad.learning_rate(cfg, k) for k in counts],
                   np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    past = np.asarray(counts) >= steps
    assert np.array_equal(got[past], want[past])
    assert got[past][0] == np.float32(np.float32(lr) * np.float32(alpha)) \
        or alpha == 0.0


def test_cosine_needs_decay_steps(small_tree):
    cfg = torch_config.RNaDConfig(lr_schedule="cosine")
    with pytest.raises(ValueError, match="lr_decay_steps"):
        torch_rnad.RNaD(torch_tree(small_tree), cfg, device="cpu")
    with pytest.raises(ValueError, match="lr_decay_steps"):
        jax_rnad.make_optimizer(RNaDConfig(lr_schedule="cosine"))


def test_three_cosine_steps_match(small_tree):
    kw = dict(batch_size=256, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
              gamma_averaging=0.01, logit_clip=2.0, lr_schedule="cosine",
              lr_decay_steps=2, lr_final_fraction=0.1)
    cfg = RNaDConfig(**kw)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A, width=32))
    step, _, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A, cfg)
    tree = torch_tree(small_tree)
    tstate = torch_rnad.init_train_state(
        torch_mlp(state.variables["params"], A, 32), torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree),
        torch_config.RNaDConfig(**kw))
    for _ in range(3):  # counts 0, 1 and 2, the last on the floor
        noise = train_step_noise(state.key, 256, A,
                                 small_tree.max_transitions,
                                 small_tree.max_depth)
        state, _ = step(state, jnp.float32(0.5))
        tstep(tstate, 0.5, noise)
    assert tstate.opt.count == 3
    got = torch_nets.params_to_flax(tstate.net)
    for layer, leaves in state.variables["params"].items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], np.asarray(want),
                                       rtol=0, atol=2e-6,
                                       err_msg=f"{layer}/{leaf}")
