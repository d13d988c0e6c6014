"""The learner step's own options of rnad_tpu_torch against rnad_tpu's
strategies and against the port's own default step.

Sizes are tests/test_rnad.py's ``small_cfg`` on the conftest's small tree:
an MLP of width 16, 48 lanes.

- One learner step on rnad_tpu's rollout against rnad_tpu's step under
  each of its strategies: ``fuse_net_passes`` "off", "heads", "frozen" and
  "all", ``frozen_net_dtype`` float32 and bfloat16, ``flat_optimizer``,
  ``detailed_metrics`` off, the associative v-trace and the batch-minor
  ``learner_layout="amb"``.  The port runs "heads" and
  "off" in the (T, B, A) layout only; where rnad_tpu runs "frozen", "all"
  or "amb" (which lost or tied on the TPU and on the H100) the port runs
  its default, with the rest of the strategy, since rnad_tpu says every
  mode computes the same losses.  Losses rtol
  1e-5, weights and target rtol 2e-6 and atol 1e-7 (tests/test_rnad.py::
  test_fuse_net_passes_same_update), except where rnad_tpu's gradient is
  below 1e-6: there Adam with b1 = 0 steps a gradient that is 0 but for
  rounding by up to lr either way in either package, and the weight is
  held within 2 lr.  The bfloat16 frozen steps are held against rnad_tpu's
  op by op (``jax.disable_jit``, whose layers round as flax's ``dtype``
  says; see tests/test_torch_nets_depth_dtype.py).
- ``flat_optimizer``: three port steps bitwise the per-leaf steps
  (weights, target, both moments, count); ``rnad_tpu``'s rule (a cosine
  schedule and bfloat16 leaves take the per-leaf path); a finite EquiNet
  step; a run stored with the flag resumes bitwise without it and the
  other way round, through ``RunStore``.
- Under two gloo ranks (tests/torch_dist_worker.py, tests/
  torch_tp_worker.py): flat + "heads" under a ``DataGroup`` against the
  one-rank step, and under a 1 x 2 grid (the model axis) against the
  port's unsharded step, at tests/test_torch_parallel.py's tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from rnad_tpu_torch.utils import checkpoint
from tests.test_torch_rnad_offpolicy import _flat
from tests.torch_parity import torch_trajectory, torch_tree

A, WIDTH, B, LR = 3, 16, 48, 1e-3
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=LR,
           gamma_averaging=0.01, logit_clip=2.0)
RTOL, ATOL = 2e-6, 1e-7
TIMEOUT = 240  # seconds a cluster may take


def _jax_net(dtype="float32"):
    return jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                        width=WIDTH, compute_dtype=dtype))


def jax_learner_step(small_tree, seed=0, eager=False, **kw):
    """rnad_tpu's rollout (the default layout's) and its learner step
    under ``kw`` (op by op where ``eager``); returns (traj, state, new,
    metrics, zero), ``zero`` True where rnad_tpu's gradient is below
    1e-6."""
    net = _jax_net()
    cfg = RNaDConfig(**CFG, **kw)
    rollout_cfg = RNaDConfig(**CFG)
    _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree,
                                                  rollout_cfg)
    _, _, learn_jit, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(seed), A, cfg)
    _, traj = rollout_jit(state)
    args = ({}, net, state.variables_target, state.variables_reg,
            state.variables_reg_, jax_stepping.make_packed_tables(small_tree),
            traj, jnp.float32(0.5), cfg)
    grads = jax.jit(jax.grad(lambda p: jax_rnad.learn_loss(p, *args)[0]))(
        state.variables["params"])
    zero = jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-6, grads)
    if eager:
        with jax.disable_jit():
            new, metrics = learn_jit(state, traj, jnp.float32(0.5))
    else:
        new, metrics = learn_jit(state, traj, jnp.float32(0.5))
    return traj, state, new, metrics, zero


def port_state(state) -> torch_rnad.TrainState:
    """The port's train state holding rnad_tpu's initial weights."""
    net = torch_nets.build_net(torch_config.NetConfig(max_actions=A,
                                                      width=WIDTH))
    net.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, state.variables["params"])))
    return torch_rnad.init_train_state(net, torch.Generator())


def assert_close(module, params, zero, rtol=RTOL, atol=ATOL):
    """``module``'s weights against flax ``params``, leaf by leaf, within
    ``rtol``/``atol`` and within 2 lr where ``zero``."""
    got, want = _flat(torch_nets.params_to_flax(module)), _flat(params)
    zero = _flat(zero)
    assert set(got) == set(want)
    for k, w in want.items():
        tol = np.where(zero[k], 2 * LR, atol + rtol * np.abs(w))
        d = np.abs(got[k] - w)
        assert (d <= tol).all(), (k, d.max())


def _port_step(small_tree, traj, state, **kw):
    tstate = port_state(state)
    metrics = torch_rnad.learn_step(
        tstate, torch_stepping.make_packed_tables(torch_tree(small_tree)),
        torch_trajectory(traj), 0.5, torch_config.RNaDConfig(**CFG, **kw))
    return tstate, metrics


# ---------------------------------------------------------------------------
# the learner steps against rnad_tpu's
# ---------------------------------------------------------------------------

MODES = {
    "off": dict(fuse_net_passes="off"),
    "heads": dict(fuse_net_passes="heads"),
    "frozen": dict(fuse_net_passes="frozen"),
    "frozen-bf16": dict(fuse_net_passes="frozen",
                        frozen_net_dtype="bfloat16"),
    "all": dict(fuse_net_passes="all"),
    "flat": dict(flat_optimizer=True),
    "amb-off": dict(learner_layout="amb", fuse_net_passes="off"),
    "amb-frozen": dict(learner_layout="amb", fuse_net_passes="frozen"),
    "amb-all": dict(learner_layout="amb", fuse_net_passes="all"),
    "amb-flat": dict(learner_layout="amb", flat_optimizer=True),
    "heads-bf16": dict(fuse_net_passes="heads", frozen_net_dtype="bfloat16"),
    "off-bf16": dict(fuse_net_passes="off", frozen_net_dtype="bfloat16"),
    "amb-heads-bf16": dict(learner_layout="amb", fuse_net_passes="heads",
                           frozen_net_dtype="bfloat16"),
    "amb-frozen-bf16": dict(learner_layout="amb", fuse_net_passes="frozen",
                            frozen_net_dtype="bfloat16"),
    # the losses and the gradient norm only
    "light": dict(detailed_metrics=False),
    "off-light": dict(fuse_net_passes="off", detailed_metrics=False),
    "frozen-light": dict(fuse_net_passes="frozen", detailed_metrics=False),
    "all-light": dict(fuse_net_passes="all", detailed_metrics=False),
    "amb-light": dict(learner_layout="amb", detailed_metrics=False),
    # the associative v-trace
    "assoc-frozen": dict(fuse_net_passes="frozen",
                         vtrace_mode="associative"),
    "assoc-all": dict(fuse_net_passes="all", vtrace_mode="associative"),
}


def port_kw(kw):
    """What the port runs of rnad_tpu's strategy ``kw``: all of it but
    the batch-minor layout and the packed fuse modes, where it runs its
    default."""
    return {k: v for k, v in kw.items()
            if k != "learner_layout"
            and not (k == "fuse_net_passes" and v in ("frozen", "all"))}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_learner_step_matches_rnad_tpu(small_tree, mode):
    kw = MODES[mode]
    bf16 = kw.get("frozen_net_dtype") == "bfloat16"
    traj, state, new, metrics, zero = jax_learner_step(small_tree, eager=bf16,
                                                       **kw)
    tstate, tmetrics = _port_step(small_tree, traj, state, **port_kw(kw))
    assert set(tmetrics) == set(metrics)
    for k in ("loss", "loss_v", "loss_nerd"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert_close(tstate.net, new.variables["params"], zero)
    assert_close(tstate.net_target, new.variables_target["params"], zero)


def test_fuse_modes_resolve_to_themselves():
    mlp = torch_nets.MLP(A, WIDTH)
    for mode in ("off", "heads"):
        assert torch_rnad.resolve_fuse_mode(
            mlp, torch_config.RNaDConfig(fuse_net_passes=mode)) == mode


# ---------------------------------------------------------------------------
# the raveled optimizer tail
# ---------------------------------------------------------------------------


def _steps(tree, cfg_kw, n=3, net_cfg=None, seed=7):
    packed = torch_stepping.make_packed_tables(tree)
    net = torch_nets.build_net(net_cfg or torch_config.NetConfig(
        max_actions=A, width=WIDTH), torch.Generator().manual_seed(seed))
    state = torch_rnad.init_train_state(net,
                                        torch.Generator().manual_seed(seed))
    cfg = torch_config.RNaDConfig(**dict(CFG, **cfg_kw))
    step = torch_rnad.make_train_step(tree, packed, cfg)
    metrics = [step(state, 0.5)[1] for _ in range(n)]
    return state, metrics


def _assert_states_equal(a, b):
    for name in ("net", "net_target", "net_reg", "net_reg_"):
        for (k, p), q in zip(getattr(a, name).state_dict().items(),
                             getattr(b, name).state_dict().values()):
            assert torch.equal(p, q), (name, k)
    for p, q in zip(a.opt.mu + a.opt.nu, b.opt.mu + b.opt.nu):
        assert torch.equal(p, q)
    assert a.opt.count == b.opt.count
    assert a.total_steps == b.total_steps


def test_flat_optimizer_bit_exact(small_tree):
    tree = torch_tree(small_tree)
    leaf, _ = _steps(tree, {})
    flat, _ = _steps(tree, dict(flat_optimizer=True))
    assert torch_rnad.uses_flat_optimizer(
        torch_config.RNaDConfig(flat_optimizer=True), flat)
    _assert_states_equal(leaf, flat)


def test_flat_rule_takes_the_per_leaf_path(small_tree):
    """A cosine schedule and bfloat16 leaves take the per-leaf path
    (rnad_tpu's ``use_flat``); under the cosine schedule the flag changes
    no bit."""
    tree = torch_tree(small_tree)
    cosine = dict(lr_schedule="cosine", lr_decay_steps=16)
    plain, _ = _steps(tree, cosine, n=2)
    flagged, _ = _steps(tree, dict(cosine, flat_optimizer=True), n=2)
    assert not torch_rnad.uses_flat_optimizer(
        torch_config.RNaDConfig(**cosine, flat_optimizer=True), flagged)
    _assert_states_equal(plain, flagged)

    cfg = torch_config.RNaDConfig(**CFG, flat_optimizer=True)
    state = torch_rnad.init_train_state(torch_nets.MLP(A, WIDTH),
                                        torch.Generator())
    assert torch_rnad.uses_flat_optimizer(cfg, state)
    for net in (state.net, state.net_target):
        net.to(torch.bfloat16)
    state.opt.mu = [m.bfloat16() for m in state.opt.mu]
    state.opt.nu = [m.bfloat16() for m in state.opt.nu]
    assert not torch_rnad.uses_flat_optimizer(cfg, state)
    twin = copy.deepcopy(state)
    grads = [torch.full_like(p, 0.5) for p in state.net.parameters()]
    torch_rnad.apply_update(cfg, state, grads)
    torch_rnad.optimizer_update(cfg, list(twin.net.parameters()), grads,
                                twin.opt)
    torch_rnad.ema_update(cfg.gamma_averaging, twin.net, twin.net_target)
    _assert_states_equal(state, twin)


def test_flat_optimizer_equinet(small_tree):
    net_cfg = torch_config.NetConfig(type="EquiNet", max_actions=A,
                                     channels=8, depth=1, solver_iters=4)
    state, metrics = _steps(torch_tree(small_tree),
                            dict(flat_optimizer=True), n=1, net_cfg=net_cfg)
    assert torch_rnad.uses_flat_optimizer(
        torch_config.RNaDConfig(flat_optimizer=True), state)
    for k, v in metrics[0].items():
        assert np.isfinite(float(v)), k


@pytest.mark.parametrize("stored,resumed", [(True, False), (False, True)])
def test_resume_across_the_flat_flag(small_tree, tmp_path, stored, resumed):
    """A run stored with one setting of the flag, resumed with the other,
    ends bitwise where the straight run without it ends."""
    tree = torch_tree(small_tree)
    net_cfg = torch_config.NetConfig(max_actions=A, width=WIDTH)

    def run(name, flat, **loop):
        cfg = torch_config.RNaDConfig(**dict(CFG, bounds=(1,),
                                             delta_m=(4,)),
                                      flat_optimizer=flat)
        trainer = torch_rnad.RNaD(tree, cfg, net_cfg, directory_name=name,
                                  runs_root=str(tmp_path), device="cpu")
        trainer.run(checkpoint_mod=2, expl_mod=0, **loop)
        return trainer

    straight = run("straight", False)
    run("split", stored)  # checkpoints at n = 0 and 2
    store = checkpoint.RunStore("split", str(tmp_path))
    assert store.latest() == (0, 2)
    resumed_run = run("split", resumed)
    assert resumed_run.state.total_steps == straight.state.total_steps == 4
    _assert_states_equal(straight.state, resumed_run.state)


# ---------------------------------------------------------------------------
# under two gloo ranks
# ---------------------------------------------------------------------------

FLAT_HEADS = dict(flat_optimizer=True, fuse_net_passes="heads")


@pytest.fixture(scope="module")
def clusters(small_tree, tmp_path_factory):
    """flat + "heads" learner cases on two gloo ranks, as a data-parallel
    pair and as a 1 x 2 grid, and the port's one-rank step on the same
    weights and trajectory."""
    root = tmp_path_factory.mktemp("learner_variants")
    tree = torch_tree(small_tree)
    tree_dir = checkpoint.save_tree(tree, "small", root=str(root / "trees"))
    packed = torch_stepping.make_packed_tables(tree)
    tcfg = torch_config.RNaDConfig(**CFG, **FLAT_HEADS)
    net_cfg = torch_config.NetConfig(max_actions=A, width=WIDTH)
    net = torch_nets.build_net(net_cfg, torch.Generator().manual_seed(0))
    traj = torch_rnad.rollout(torch_rnad.init_train_state(
        copy.deepcopy(net), torch.Generator().manual_seed(3)), tree, packed,
        tcfg)
    state = torch_rnad.init_train_state(copy.deepcopy(net),
                                        torch.Generator())
    loss, _ = torch_rnad.learn_loss(state, packed, traj, 0.5, tcfg)
    grads = torch.autograd.grad(loss, list(state.net.parameters()))
    zero = {n: g.abs() < 1e-6
            for (n, _), g in zip(state.net.named_parameters(), grads)}
    one = torch_rnad.init_train_state(copy.deepcopy(net), torch.Generator())
    metrics = torch_rnad.learn_step(one, packed, traj, 0.5, tcfg)
    case = {"kind": "learn", "tree_dir": tree_dir, "cfg": tcfg.to_json(),
            "net": net_cfg.to_json(), "state_dict": net.state_dict(),
            "alpha": 0.5, "seed": 0,
            "traj": {f: getattr(traj, f) for f in
                     ("indices", "policy", "actions", "rewards", "values")}}
    out = {}
    for kind, module, extra in (
            ("data", "tests.torch_dist_worker", []),
            ("grid", "tests.torch_tp_worker",
             ["--model-parallelism", "2"])):
        wdir = root / kind
        wdir.mkdir()
        cases = {"flat_frozen": dict(case, batch_norm="global")}
        torch.save(cases, wdir / "cases.pt")
        mpc.spawn(2, ["--cases", str(wdir / "cases.pt"), "--out",
                      str(wdir), *extra], TIMEOUT, device="cpu",
                  module=module)
        out[kind] = [torch.load(wdir / f"rank{r}.pt", weights_only=True)
                     ["flat_frozen"] for r in range(2)]
    return ({k: float(v) for k, v in metrics.items()}, one, zero), out


def _assert_rank(got_metrics, got_net, want, what):
    metrics, one, zero = want
    assert set(got_metrics) == set(metrics), what
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k], metrics[k], rtol=2e-5,
                                   atol=1e-6, err_msg=f"{what}: {k}")
    want_sd = one.net.state_dict()
    for name, mask in zero.items():
        d = (got_net[name] - want_sd[name]).abs()
        tol = torch.where(mask, 2 * LR, 2e-6)
        assert (d <= tol).all(), f"{what}: {name} off by {float(d.max())}"


def test_flat_frozen_data_parallel_matches_one_rank(clusters):
    want, out = clusters
    for r, res in enumerate(out["data"]):
        _assert_rank(res["metrics"], res["state_dict"], want, f"rank {r}")
        for k, v in res["state_dict"].items():  # replicated, bitwise
            assert torch.equal(v, out["data"][0]["state_dict"][k]), k


def test_flat_frozen_model_axis_matches_unsharded(clusters):
    want, out = clusters
    for r, res in enumerate(out["grid"]):
        whole = res["whole"]
        _assert_rank(res["metrics"], whole["nets"]["net"], want,
                     f"grid rank {r}")
        target = want[1].net_target.state_dict()
        for k, v in whole["nets"]["net_target"].items():
            d = (v - target[k]).abs()
            assert (d <= 2 * LR).all(), k
