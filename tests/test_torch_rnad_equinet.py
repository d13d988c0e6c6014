"""The EquiNet train step of rnad_tpu_torch.learn.rnad against rnad_tpu's,
the fuse and rollout-route errors, and chunked NashConv inference.

From the same weights, the same rollout noise and the same solves (see
``jax_solves``), one fused train step (generic rollout turn, one shared
solve, the "off" learner passes) must give the same new parameters (atol
1e-6: Adam with b1=0 moves each weight by at most lr, so this is a tight
bound on the update, except on the few weights whose gradient is 0 but for
rounding: 2 lr, see ``_zero_gradients``) and the same losses (rtol 1e-5),
also where rnad_tpu runs its batch-minor ``learner_layout="amb"`` (which
the port does not run: its one (T, B, A) path stands in for it); five
steps with a rotation give the same target-net NashConv within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.env import solver_device as jax_sd
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.metrics import nashconv as jax_nashconv
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.metrics import nashconv as torch_nashconv
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import torch_equinet, torch_tree, train_step_noise

A, CH, DEPTH, B = 3, 16, 2, 256
# n_discrete: the EquiNet is equivariant, so a node with two identical
# legal rows gets two equal probabilities, equal up to an ulp that differs
# between the packages.  process_policy grants its last 1/n_discrete block
# by their order, so at the default of 32 blocks one ulp moves 1/32 of
# probability (and the loss by ~1e-3); at 2**16 blocks it moves 2**-16.
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0, n_discrete=2**16)


def _net_kw(solver_iters, solver_prime):
    return dict(type="EquiNet", max_actions=A, channels=CH, depth=DEPTH,
                solver_iters=solver_iters, solver_prime=solver_prime)


def _pair(small_tree, solver_iters=16, solver_prime=True, seed=0,
          jax_kw=None, **kw):
    """rnad_tpu's fused step, NashConv, state and net under ``kw`` and
    ``jax_kw``, and the port's step, tree and state under ``kw``."""
    cfg = RNaDConfig(**CFG, **kw, **(jax_kw or {}))
    net = jax_nets.build_net(NetConfig(**_net_kw(solver_iters,
                                                 solver_prime)))
    train_step, _, _, nashconv_fn = jax_rnad.make_rnad_fns(net, small_tree,
                                                           cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(seed), A, cfg)
    tree = torch_tree(small_tree)
    tcfg = torch_config.RNaDConfig(**CFG, **kw)
    tnet = torch_equinet(state.variables["params"], A, CH, DEPTH,
                         solver_iters, solver_prime)
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree), tcfg)
    return (train_step, nashconv_fn, state, net), (tstep, tree, tstate)


@pytest.fixture
def jax_solves(monkeypatch):
    """The port's EquiNet solves with rnad_tpu's RM+ loop, so that both
    packages read the same solver features and the comparison holds the
    train step alone.  float32 RM+ runs whose sums are taken in another
    order part ways on a few games (``solver_device.agreement``), and the
    log x channels magnify small differences near 0; the port's own solve
    is held by tests/test_torch_rmplus.py and tests/test_torch_equinet.py."""

    def solve(payoffs, legal_rows, legal_cols, iters):
        out = jax_sd.solve_zero_sum_rmplus(
            *(jnp.asarray(t.numpy()) for t in (payoffs, legal_rows,
                                               legal_cols)), iters=iters)
        return tuple(torch.from_numpy(np.array(o)) for o in out)

    monkeypatch.setattr(torch_nets.solver_device, "solve_zero_sum_rmplus",
                        solve)


def _noise(small_tree, state):
    return train_step_noise(state.key, B, A, small_tree.max_transitions,
                            small_tree.max_depth)


def _zero_gradients(net, small_tree, state, alpha):
    """True where rnad_tpu's gradient of the step's loss is numerically 0
    (below 1e-6).  The policy head's bias and its weights on inputs that
    are the same for every row (the legality, y, log y and u_c pools of the
    input skip) shift all of a row's logits alike, which the loss does not
    see; Adam with b1=0 scales such a gradient's rounding noise to a step
    of up to lr, in either package."""
    cfg = RNaDConfig(**CFG)
    _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    _, traj = rollout_jit(state)
    packed = jax_stepping.make_packed_tables(small_tree)
    loss = lambda p: jax_rnad.learn_loss(
        p, {}, net, state.variables_target, state.variables_reg,
        state.variables_reg_, packed, traj, jnp.float32(alpha), cfg)[0]
    grads = jax.grad(loss)(state.variables["params"])
    return jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-6, grads)


def _assert_params_close(module, params, atol, loose=None):
    """Within ``atol``, and within 2 lr (each package's step may go either
    way) where ``loose`` (a tree of masks)."""
    got = torch_nets.params_to_flax(module)
    want = jax.tree.map(np.asarray, params)
    assert set(got) == set(want)
    for name, layer in want.items():
        leaves = layer if isinstance(layer, dict) else {None: layer}
        for leaf, w in leaves.items():
            g = got[name] if leaf is None else got[name][leaf]
            tol = np.full(np.shape(w), atol, np.float32)
            if loose is not None:
                mask = loose[name] if leaf is None else loose[name][leaf]
                tol = np.where(mask, 2 * CFG["lr"], tol)
            assert (np.abs(g - w) <= tol).all(), (
                f"{name}/{leaf}", np.abs(g - w).max())


@pytest.mark.parametrize("solver_prime", [True, False])
def test_one_fused_step_matches(small_tree, solver_prime, jax_solves):
    _assert_one_fused_step(small_tree, solver_prime)


@pytest.mark.parametrize("solver_prime", [True, False])
def test_one_fused_step_matches_rnad_tpus_amb_step(small_tree, solver_prime,
                                                   jax_solves):
    """rnad_tpu's step in its batch-minor layout (its rollout records the
    (T, A, B) policy) against the port's (T, B, A) step."""
    _assert_one_fused_step(small_tree, solver_prime,
                           dict(learner_layout="amb"))


def _assert_one_fused_step(small_tree, solver_prime, jax_kw=None):
    (step, _, state, net), (tstep, _, tstate) = _pair(
        small_tree, solver_prime=solver_prime, jax_kw=jax_kw)
    noise = _noise(small_tree, state)
    zero = _zero_gradients(net, small_tree, state, 0.5)
    new, metrics = step(state, jnp.float32(0.5))
    _, tmetrics = tstep(tstate, 0.5, noise)
    _assert_params_close(tstate.net, new.variables["params"], 1e-6, zero)
    _assert_params_close(tstate.net_target, new.variables_target["params"],
                         1e-6, zero)
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert set(tmetrics) == set(metrics)
    for k in ("traj_len", "logit_mean", "logit_max", "entropy",
              "entropy_target", "actor_learner_kld", "gradient_norm"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_five_steps_nashconv_matches(small_tree, jax_solves):
    (step, nashconv_fn, state, _), (tstep, tree, tstate) = _pair(small_tree,
                                                                 seed=1)
    for n in range(5):
        alpha = jax_rnad.alpha_schedule(n, 4)
        noise = _noise(small_tree, state)
        state, _ = step(state, jnp.float32(alpha))
        tstep(tstate, alpha, noise)
        if n == 2:  # an update boundary
            state = jax_rnad.rotate_regularization_nets(state)
            torch_rnad.rotate_regularization_nets(tstate)
    want = float(nashconv_fn(state.variables_target).nashconv())
    got = float(torch_rnad.nashconv(tree, tstate.net_target).nashconv())
    assert abs(got - want) < 1e-4


@pytest.mark.parametrize("mode", ["heads"])
def test_fuse_mode_errors_match_jax(mode):
    jnet = jax_nets.build_net(NetConfig(**_net_kw(16, True)))
    tnet = torch_nets.build_net(torch_config.NetConfig(**_net_kw(16, True)))
    cfg = RNaDConfig(fuse_net_passes=mode)
    tcfg = torch_config.RNaDConfig(fuse_net_passes=mode)
    with pytest.raises(ValueError) as want:
        jax_rnad.resolve_fuse_mode(jnet, cfg)
    with pytest.raises(ValueError) as got:
        torch_rnad.resolve_fuse_mode(tnet, tcfg)
    assert str(got.value) == str(want.value)


def test_fuse_mode_resolution():
    equi = torch_nets.build_net(torch_config.NetConfig(**_net_kw(0, False)))
    mlp = torch_nets.build_net(torch_config.NetConfig(max_actions=A, width=8))
    resolve = lambda net, mode: torch_rnad.resolve_fuse_mode(
        net, torch_config.RNaDConfig(fuse_net_passes=mode))
    assert resolve(equi, "auto") == resolve(equi, "off") == "off"
    assert resolve(mlp, "auto") == "heads"
    assert resolve(mlp, "off") == "off"


def test_trainer_rejects_before_the_first_step(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    for field, value in (("fuse_net_passes", "heads"),
                         ("rollout_rows_actor", "on")):
        run = torch_rnad.RNaD(
            tree, torch_config.RNaDConfig(batch_size=8, **{field: value}),
            torch_config.NetConfig(**_net_kw(4, True)), directory_name=field,
            runs_root=str(tmp_path), device="cpu")
        with pytest.raises(ValueError):
            run.initialize()
        assert not run.store.exists()  # raised before touching the store


def test_mlp_off_mode_equals_heads(small_tree):
    """The MLP's "off" learner (whole frozen forwards) gives the "heads"
    learner's update."""
    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    out = []
    for mode in ("heads", "off"):
        cfg = torch_config.RNaDConfig(**CFG, fuse_net_passes=mode)
        net = torch_nets.build_net(
            torch_config.NetConfig(max_actions=A, width=16),
            torch.Generator().manual_seed(0))
        state = torch_rnad.init_train_state(
            net, torch.Generator().manual_seed(1))
        _, metrics = torch_rnad.make_train_step(tree, packed, cfg)(state, 0.5)
        out.append((metrics, list(state.net.parameters())))
    for k in out[0][0]:
        torch.testing.assert_close(out[1][0][k], out[0][0][k], rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


@pytest.mark.parametrize("chunk", [10, 64])
def test_chunked_joint_policy(small_tree, chunk, jax_solves):
    """Chunked inference (padded tail chunk) equals the whole-tree pass
    and rnad_tpu's chunked inference, and NashConv through it equals the
    trainer hook's."""
    (_, _, state, net), _ = _pair(small_tree, solver_iters=16, seed=2)
    variables = state.variables
    tnet = torch_equinet(variables["params"], A, CH, DEPTH, 16, True)
    tree = torch_tree(small_tree)
    assert tree.size % chunk  # a padded tail chunk
    whole = torch_nashconv.joint_policy_all_nodes(tree, tnet)
    got = torch_nashconv.joint_policy_from_net(tree, tnet, chunk)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
    apply = lambda vs, obs: jax_nets.apply_eval(net, vs, obs)
    want = jax_nashconv.joint_policy_from_net(small_tree, apply, variables,
                                              inference_batch_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    chunked = torch_rnad.nashconv(tree, tnet, chunk_nodes=chunk)
    one = torch_rnad.nashconv(tree, tnet)
    assert abs(float(chunked.nashconv()) - float(one.nashconv())) < 1e-5
    ref = jax_nashconv.nashconv_root(small_tree, want)
    assert abs(float(chunked.nashconv()) - float(ref.nashconv())) < 1e-4


def test_rnad_equinet_loop_evaluates_in_chunks(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    cfg = torch_config.RNaDConfig(batch_size=32, bounds=(2,), delta_m=(2,),
                                  lr=1e-3, nashconv_chunk_nodes=50)
    run = torch_rnad.RNaD(tree, cfg,
                          torch_config.NetConfig(**_net_kw(8, True)),
                          runs_root=str(tmp_path), device="cpu")
    run.run(log_mod=1)
    value = run.final_eval()
    assert run.state.total_steps == 4
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    assert len(evals) == 2 and evals[-1] == value and np.isfinite(value)
    whole = torch_rnad.nashconv(tree, run.state.net_target)
    assert abs(float(whole.nashconv()) - value) < 1e-5
