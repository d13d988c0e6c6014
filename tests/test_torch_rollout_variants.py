"""The rollout's variants of rnad_tpu_torch.env.engine against rnad_tpu's:
stored observations (``store_obs``, ``RNaDConfig.store_rollout_obs``) and
``lane_chunks``, the port's (T, B, A) policy record against rnad_tpu's
batch-minor one (``policy_minor``, the record of its TPU layout, which the
port does not run), and the learner steps that read them.

The noise is drawn with jax.random under rnad_tpu's key discipline (for a
chunked rollout: one key a chunk, ``jax.random.split(key, k)``, each chunk's
noise assembled into the full batch's columns) and handed to both packages,
so the episodes are the same: indices, actions, rewards and observations
equal; policy and values within the engine tests' rtol 1e-5, atol 1e-6
(rnad_tpu's (T, A, B) record transposed, where it records that).  Within
the port, what the variants change is a copy, so the port holds itself
bitwise: stored observations are the regathered ones, a chunked rollout
on the same full-batch noise is the whole one, and a train step that
stores the observations is the regather step.  The steps match rnad_tpu's
at tests/test_torch_rnad.py's tolerance (weights atol 1e-6, losses rtol
1e-5).
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
from rnad_tpu_torch.learn import buffer as torch_buffer
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_torch_rnad_equinet import jax_solves
from tests.torch_parity import (rollout_noise, torch_equinet, torch_mlp,
                                torch_tree, train_step_noise)

assert jax_solves  # a fixture, used by name below

A, WIDTH, B = 3, 32, 128
FIELDS = ("indices", "policy", "actions", "rewards", "values", "obs")
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)


@pytest.fixture(scope="module")
def pair(small_tree):
    """rnad_tpu's MLP, rollout pieces and tree, and the port's."""
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(5), A)
    packed = jax_stepping.make_packed_tables(small_tree)
    tree = torch_tree(small_tree)
    return {"actor": lambda vs, obs: jax_nets.apply_eval(net, vs, obs),
            "variables": variables, "packed": packed,
            "rows_actor": jax_engine.make_mlp_rows_actor(net, packed),
            "tree": tree, "tpacked": torch_stepping.make_packed_tables(tree),
            "tnet": torch_mlp(variables["params"], A, WIDTH)}


def chunked_noise(key, batch, T, turns, chunks):
    """The full batch's per-turn noise of rnad_tpu's
    ``rollout_from(lane_chunks=chunks)``: chunk c rolls out its ``batch /
    chunks`` lanes from the c-th key of ``split(key, chunks)``; its
    ``g_act`` rows are the row seat's lanes of the chunk, then the column
    seat's, so they go to two row ranges of the full (2B, A) noise."""
    b = batch // chunks
    per = [rollout_noise(k, b, A, T, turns)
           for k in jax.random.split(key, chunks)]
    return [(torch.cat([p[t][0][:b] for p in per]
                       + [p[t][0][b:] for p in per]),
             torch.cat([p[t][1] for p in per])) for t in range(turns)]


def _jax_rollout(pair, small_tree, key, rows_actor, **kw):
    return jax_engine.rollout_from(
        small_tree, pair["actor"], pair["variables"], key,
        jnp.ones((B,), jnp.int32), small_tree.max_depth, pair["packed"],
        rows_actor=pair["rows_actor"] if rows_actor == "on" else None, **kw)


def _port_rollout(pair, noise, rows_actor, **kw):
    return torch_engine.rollout_from(
        pair["tree"], pair["tpacked"], pair["tnet"],
        torch.ones((B,), dtype=torch.int32), noise=noise,
        rows_actor=rows_actor, **kw)


def _assert_episodes(got, want, bitwise_obs=True):
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.policy.numpy(),
                               np.asarray(want.policy_bma()), rtol=1e-5,
                               atol=1e-6)
    if bitwise_obs:
        np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))


def _assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


@pytest.mark.parametrize("rows_actor", ["on", "off"])
def test_stored_obs_are_regathered_and_rnad_tpus(pair, small_tree,
                                                 rows_actor):
    """K1's stored observations (its plain version here) and the generic
    turn's are the regathered ones, and rnad_tpu's ``store_obs=True``
    record; storing them changes no other field."""
    key = jax.random.PRNGKey(7)
    want = _jax_rollout(pair, small_tree, key, rows_actor, store_obs=True)
    noise = rollout_noise(key, B, A, small_tree.max_transitions,
                          small_tree.max_depth)
    stored = _port_rollout(pair, noise, rows_actor, store_obs=True)
    bare = _port_rollout(pair, noise, rows_actor)
    assert bare.obs is None
    assert stored.obs.shape == (2 * small_tree.max_depth, B, 2, A, A)
    _assert_episodes(stored, want)
    _assert_same(dataclass_without_obs(stored), bare)
    obs, masks = torch_engine.trajectory_observations(pair["tpacked"], bare)
    s_obs, s_masks = torch_engine.trajectory_observations(pair["tpacked"],
                                                          stored)
    assert torch.equal(s_obs, obs) and torch.equal(s_masks, masks)


def dataclass_without_obs(traj):
    return torch_engine.Trajectory(
        **{f: getattr(traj, f) for f in FIELDS if f != "obs"})


def test_stored_obs_in_another_dtype(pair, small_tree):
    """``obs_dtype`` casts the stored observations (the generic turn's and
    K1's alike); the values are the packed rows' small integers and
    payoffs, so a bfloat16 record is the float32 one rounded."""
    noise = rollout_noise(jax.random.PRNGKey(8), B, A,
                          small_tree.max_transitions, small_tree.max_depth)
    f32 = _port_rollout(pair, noise, "on", store_obs=True)
    for rows_actor in ("on", "off"):
        bf16 = _port_rollout(pair, noise, rows_actor, store_obs=True,
                             obs_dtype=torch.bfloat16)
        assert bf16.obs.dtype == torch.bfloat16
        assert torch.equal(bf16.obs, f32.obs.to(torch.bfloat16))


@pytest.mark.parametrize("rows_actor", ["on", "off"])
@pytest.mark.parametrize("chunks", [2, 4])
def test_lane_chunks_match_rnad_tpus(pair, small_tree, rows_actor, chunks):
    """A chunked rollout plays rnad_tpu's chunked episodes on its
    per-chunk keys; on the same full-batch noise the port's chunked
    rollout is bitwise its whole one."""
    key = jax.random.PRNGKey(9)
    want = _jax_rollout(pair, small_tree, key, rows_actor, store_obs=True,
                        lane_chunks=chunks)
    noise = chunked_noise(key, B, small_tree.max_transitions,
                          small_tree.max_depth, chunks)
    got = _port_rollout(pair, noise, rows_actor, store_obs=True,
                        lane_chunks=chunks)
    _assert_episodes(got, want)
    _assert_same(got, _port_rollout(pair, noise, rows_actor,
                                    store_obs=True))


def test_lane_chunks_from_a_generator_roll_each_chunk_in_turn(pair):
    """From a generator each chunk draws its own turns' noise, in chunk
    order: the chunked rollout is the chunks' rollouts concatenated (other
    episodes than the whole rollout's, as in rnad_tpu)."""
    tree, packed, net = pair["tree"], pair["tpacked"], pair["tnet"]
    init = torch.ones((B,), dtype=torch.int32)
    got = torch_engine.rollout_from(tree, packed, net, init, lane_chunks=2,
                                    generator=torch.Generator().manual_seed(3),
                                    store_obs=True)
    gen = torch.Generator().manual_seed(3)
    parts = [torch_engine.rollout_from(tree, packed, net, init[:B // 2],
                                       generator=gen, store_obs=True)
             for _ in range(2)]
    for f in FIELDS:
        assert torch.equal(getattr(got, f), torch.cat(
            [getattr(p, f) for p in parts], 1)), f


@pytest.mark.parametrize("rows_actor", ["on", "off"])
@pytest.mark.parametrize("chunks", [1, 2])
def test_policy_minor_is_the_record_transposed(pair, small_tree, rows_actor,
                                               chunks):
    """rnad_tpu's ``policy_minor`` record (T, A, B), the record of its
    batch-minor learner, is the port's (T, B, A) record transposed, within
    the engine tests' tolerance, through the chunks' stitch; every other
    field is its (T, B, A) record's."""
    key = jax.random.PRNGKey(11)
    noise = (rollout_noise(key, B, A, small_tree.max_transitions,
                           small_tree.max_depth) if chunks == 1 else
             chunked_noise(key, B, small_tree.max_transitions,
                           small_tree.max_depth, chunks))
    kw = dict(store_obs=True, lane_chunks=chunks)
    _assert_minor_record(
        _port_rollout(pair, noise, rows_actor, **kw),
        _jax_rollout(pair, small_tree, key, rows_actor, policy_minor=True,
                     **kw))


@pytest.mark.parametrize("rows_actor", ["on", "off"])
def test_unstored_record_is_rnad_tpus_minor_record_transposed(
        pair, small_tree, rows_actor):
    """As above, without stored observations (the learner regathers)."""
    key = jax.random.PRNGKey(12)
    noise = rollout_noise(key, B, A, small_tree.max_transitions,
                          small_tree.max_depth)
    got = _port_rollout(pair, noise, rows_actor)
    assert got.obs is None
    _assert_minor_record(got, _jax_rollout(pair, small_tree, key, rows_actor,
                                           policy_minor=True),
                         bitwise_obs=False)


@pytest.mark.parametrize("store", [True, False])
def test_equinet_record_is_rnad_tpus_minor_record_transposed(
        small_tree, jax_solves, store):
    """The generic turn of the solver EquiNet (the solves rnad_tpu's, see
    ``jax_solves``): the port's record against rnad_tpu's ``policy_minor``
    one, transposed, with stored observations and without."""
    net = jax_nets.build_net(NetConfig(type="EquiNet", max_actions=A,
                                       channels=8, depth=2, solver_iters=16,
                                       solver_prime=True))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(6), A)
    key = jax.random.PRNGKey(13)
    want = jax_engine.rollout_from(
        small_tree, lambda vs, obs: jax_nets.apply_eval(net, vs, obs),
        variables, key, jnp.ones((B,), jnp.int32), small_tree.max_depth,
        jax_stepping.make_packed_tables(small_tree), store_obs=store,
        policy_minor=True)
    tree = torch_tree(small_tree)
    got = torch_engine.rollout_from(
        tree, torch_stepping.make_packed_tables(tree),
        torch_equinet(variables["params"], A, 8, 2, 16, True),
        torch.ones((B,), dtype=torch.int32),
        noise=rollout_noise(key, B, A, small_tree.max_transitions,
                            small_tree.max_depth), store_obs=store)
    assert (got.obs is not None) == store
    _assert_minor_record(got, want, bitwise_obs=store)


def _assert_minor_record(got, want, bitwise_obs=True):
    """The port's record against rnad_tpu's (T, A, B) one: its policy is
    compared transposed (``policy_bma``) in ``_assert_episodes``."""
    T = got.num_half_steps
    assert tuple(got.policy.shape) == (T, B, A)
    assert np.shape(want.policy) == (T, A, B)
    _assert_episodes(got, want, bitwise_obs)


@pytest.mark.parametrize("chunks,match", [
    (0, "lane_chunks must be >= 1"), (-1, "lane_chunks must be >= 1"),
    (3, f"batch {B} not divisible by 3")])
def test_variant_errors_are_rnad_tpus(pair, small_tree, chunks, match):
    with pytest.raises(ValueError, match=match):
        _jax_rollout(pair, small_tree, jax.random.PRNGKey(0), "on",
                     lane_chunks=chunks)
    with pytest.raises(ValueError, match=match):
        _port_rollout(pair, None, "on", lane_chunks=chunks)


def _jax_pair(small_tree, seed=0, **kw):
    cfg = RNaDConfig(**CFG, **kw)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    train_step, _, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(seed), A, cfg)
    return train_step, state


def _params_close(module, params, atol):
    got = torch_nets.params_to_flax(module)
    for layer in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(params[layer][leaf]),
                                       rtol=0, atol=atol,
                                       err_msg=f"{layer}/{leaf}")


def _port_step(tree, net, cfg, noise, alpha=0.5):
    state = torch_rnad.init_train_state(net, torch.Generator())
    packed = torch_stepping.make_packed_tables(tree)
    _, metrics, traj = torch_rnad.make_train_step(tree, packed, cfg)(
        state, alpha, noise, with_trajectory=True)
    return state, metrics, traj


def _assert_states_equal(a, b):
    for net in ("net", "net_target"):
        for x, y in zip(getattr(a, net).state_dict().values(),
                        getattr(b, net).state_dict().values()):
            assert torch.equal(x, y), net


@pytest.mark.parametrize("layout", ["bma"])
def test_stored_obs_mlp_step_is_the_regather_step(small_tree, layout):
    """The MLP step with ``store_rollout_obs`` is bitwise the regather
    step (weights, target, metrics), and both match rnad_tpu's step (with
    each setting) from the same weights and noise."""
    tree = torch_tree(small_tree)
    out = {}
    for store in (True, False):
        step, state = _jax_pair(small_tree, store_rollout_obs=store,
                                learner_layout=layout)
        noise = train_step_noise(state.key, B, A, small_tree.max_transitions,
                                 small_tree.max_depth)
        new, metrics = step(state, jnp.float32(0.5))
        tcfg = torch_config.RNaDConfig(**CFG, store_rollout_obs=store,
                                       learner_layout=layout)
        tstate, tmetrics, traj = _port_step(
            tree, torch_mlp(state.variables["params"], A, WIDTH), tcfg,
            noise)
        assert (traj.obs is not None) == store
        _params_close(tstate.net, new.variables["params"], 1e-6)
        _params_close(tstate.net_target, new.variables_target["params"],
                      1e-6)
        for k in ("loss", "loss_v", "loss_nerd"):
            np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                       rtol=1e-5, err_msg=k)
        out[store] = (tstate, tmetrics)
    _assert_states_equal(out[True][0], out[False][0])
    assert all(torch.equal(out[True][1][k], out[False][1][k])
               for k in out[True][1])


def test_stored_obs_equinet_step_is_the_regather_step(small_tree):
    """The solver EquiNet's step (the generic turn stores the
    observations; the learner solves them, K3's plain version) is bitwise
    the regather step."""
    tree = torch_tree(small_tree)
    noise = rollout_noise(jax.random.PRNGKey(6), B, A,
                          small_tree.max_transitions, small_tree.max_depth)
    net_cfg = torch_config.NetConfig(type="EquiNet", max_actions=A,
                                     channels=8, depth=2, solver_iters=16,
                                     solver_prime=True)
    out = {}
    for store in (True, False):
        net = torch_nets.build_net(net_cfg, torch.Generator().manual_seed(1))
        cfg = torch_config.RNaDConfig(**CFG, store_rollout_obs=store)
        state, metrics, traj = _port_step(tree, net, cfg, noise)
        assert (traj.obs is not None) == store
        out[store] = (state, metrics)
    _assert_states_equal(out[True][0], out[False][0])
    assert all(torch.equal(out[True][1][k], out[False][1][k])
               for k in out[True][1])


def test_stored_obs_buffered_steps_are_the_regather_steps(small_tree,
                                                          tmp_path):
    """Four buffered learner steps (2 slots, a rollout every 2 steps): the
    slots hold the stored observations and the collated batch carries
    them; the weights are bitwise the regather run's."""
    tree = torch_tree(small_tree)
    runs = {}
    for store in (True, False):
        cfg = torch_config.RNaDConfig(**CFG, n_batches_per_buffer=2,
                                      buffer_mod=2, store_rollout_obs=store)
        run = torch_rnad.RNaD(tree, cfg, torch_config.NetConfig(
            max_actions=A, width=WIDTH), directory_name=f"s{store}",
            runs_root=str(tmp_path), device="cpu")
        run.initialize()
        buf = torch_buffer.TrajectoryBuffer(2)
        for _ in range(4):
            run.buffered_step(buf, 0.5)
        assert all((t.obs is not None) == store for t in buf.slots)
        sample = buf.sample(B, np.random.default_rng(0))
        assert (sample.obs is not None) == store
        runs[store] = run
    _assert_states_equal(runs[True].state, runs[False].state)
