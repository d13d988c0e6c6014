"""The port's data parallelism (``rnad_tpu_torch/parallel/``) against one
rank and against ``rnad_tpu``'s shard_map path.

Every multi-rank case runs in spawned CPU processes over gloo (one thread
each, a time limit on every cluster; ``multiprocess_check.spawn``):

* the learner update on a fixed trajectory (``make_shard_map_learn_step``)
  on 2 and 4 ranks against the port's one-rank ``learn_step`` and against
  ``rnad_tpu``'s ``make_shard_map_learn_step`` on the conftest's 8 virtual
  devices, from the same converted weights and trajectory: metrics within
  rtol 2e-5 / atol 1e-6 and weights within 2e-6
  (tests/test_sharding.py:194-202), for an MLP and a solver EquiNet;
* the global-stream fused step (``runtime.py``) on 2 ranks against one:
  the same episodes lane for lane, losses and the weights' checksum
  within rtol 1e-4 (tests/test_multiprocess.py:25-28), a run saved on 2
  ranks and resumed on 4 against the straight one-rank run;
* the per-rank-stream step (weights identical on every rank) and a
  ConvNet's per-rank BatchNorm under it (running statistics the mean of
  the lane slices').  The global-stream path's global BatchNorm and its
  buffered step are tests/test_torch_parallel_global.py's and tests/
  test_torch_parallel_buffered.py's.

The EquiNet's policy head shifts every logit of a row alike (the bias, and
its weights on pooled inputs equal across a row), which the loss does not
see: its gradient is 0 but for rounding, and Adam with b1 = 0 turns that
rounding into a step of up to lr either way (tests/
test_torch_rnad_equinet.py::_zero_gradients).  Weights whose one-rank
gradient is below 1e-6 are held within 2 lr instead of 2e-6.  Against
``rnad_tpu`` the EquiNet reads ``rnad_tpu``'s solves in the in-process
one-rank update (float32 RM+ in another order parts on a few games,
``solver_device.agreement``); the spawned ranks solve with the port's own
RM+ and are held against the port's one-rank update on the same solves.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.parallel import mesh as jax_mesh
from rnad_tpu.parallel import shard_map_step as jax_sms
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from rnad_tpu_torch.parallel import mesh as torch_mesh
from rnad_tpu_torch.parallel import runtime
from rnad_tpu_torch.parallel.shard_map_step import lane_slice
from rnad_tpu_torch.utils import checkpoint
from tests.torch_parity import (jax_solve, torch_convnet, torch_equinet,
                                torch_mlp, torch_trajectory, torch_tree)

A, B, ALPHA, LR = 3, 64, 0.5, 1e-3
CFG = dict(batch_size=B, eta=0.2, bounds=(1,), delta_m=(2,), lr=LR,
           gamma_averaging=0.01, logit_clip=2.0)
NETS = {
    "mlp": dict(type="MLP", max_actions=A, width=32),
    # n_discrete: see tests/test_torch_rnad_equinet.py (equivariant ties)
    "equinet": dict(type="EquiNet", max_actions=A, channels=8, depth=2,
                    solver_iters=16, solver_prime=True),
    "convnet": dict(type="ConvNet", max_actions=A, channels=8, depth=1,
                    batch_norm=True),
}
CFG_EXTRA = {"equinet": dict(n_discrete=2**16)}
TIMEOUT = 240  # seconds a cluster may take
METRIC_TOL = dict(rtol=2e-5, atol=1e-6)
WEIGHT_ATOL = 2e-6


def _to_torch_net(kind, variables):
    kw = NETS[kind]
    if kind == "mlp":
        return torch_mlp(variables["params"], A, kw["width"])
    if kind == "equinet":
        return torch_equinet(variables["params"], A, kw["channels"],
                             kw["depth"], kw["solver_iters"],
                             kw["solver_prime"])
    return torch_convnet(variables, A, kw["channels"], kw["depth"])


def _one_rank(tnet, tree, tcfg, ttraj):
    """The port's one-rank learner update; returns (metrics, state dict,
    mask of the weights whose gradient is numerically 0)."""
    packed = torch_stepping.make_packed_tables(tree)
    state = torch_rnad.init_train_state(copy.deepcopy(tnet),
                                        torch.Generator())
    loss, _ = torch_rnad.learn_loss(state, packed, ttraj, ALPHA, tcfg)
    grads = torch.autograd.grad(loss, list(state.net.parameters()))
    state = torch_rnad.init_train_state(copy.deepcopy(tnet),
                                        torch.Generator())
    metrics = torch_rnad.learn_step(state, packed, ttraj, ALPHA, tcfg)
    zero = {name: g.abs() < 1e-6 for (name, _), g in
            zip(state.net.named_parameters(), grads)}
    return ({k: float(v) for k, v in metrics.items()},
            state.net.state_dict(), zero)


@pytest.fixture(scope="module")
def learn_cases(small_tree, tmp_path_factory):
    """Per net: rnad_tpu's shard_map update on 8 devices, the port's
    one-rank update (the EquiNet on rnad_tpu's solves and on its own), and
    the spawned clusters' results on 2 and 4 ranks (the ConvNet on 2)."""
    root = tmp_path_factory.mktemp("parallel")
    tree = torch_tree(small_tree)
    tree_dir = checkpoint.save_tree(tree, "small", root=str(root / "trees"))
    found, cases = {}, {}
    for kind in ("mlp", "equinet", "convnet"):
        cfg_kw = dict(CFG, **CFG_EXTRA.get(kind, {}))
        net = jax_nets.build_net(NetConfig(**NETS[kind]))
        cfg = RNaDConfig(**cfg_kw)
        _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
        state0 = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A,
                                           cfg)
        _, traj = rollout_jit(state0)
        tnet = _to_torch_net(kind, state0.variables)
        ttraj = torch_trajectory(traj, keep_obs=False)
        tcfg = torch_config.RNaDConfig(**cfg_kw)
        entry = {"one_rank": _one_rank(tnet, tree, tcfg, ttraj),
                 "traj": ttraj, "tnet": tnet}
        # the ConvNet's BatchNorm is per shard: 2 devices, as the ranks
        mesh = jax_mesh.make_mesh(jax.devices()[:2] if kind == "convnet"
                                  else None)
        learn = jax_sms.make_shard_map_learn_step(net, small_tree, cfg, mesh)
        new, metrics = learn(state0, traj, ALPHA)
        entry["rnad_tpu"] = ({k: float(v) for k, v in metrics.items()},
                             jax.tree.map(np.asarray, dict(new.variables)))
        if kind == "equinet":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(torch_nets.solver_device,
                           "solve_zero_sum_rmplus", jax_solve)
                entry["one_rank_jax_solves"] = _one_rank(tnet, tree, tcfg,
                                                         ttraj)
        found[kind] = entry
        cases[kind] = {
            "kind": "learn", "tree_dir": tree_dir, "cfg": tcfg.to_json(),
            "net": torch_config.NetConfig(**NETS[kind]).to_json(),
            "state_dict": tnet.state_dict(), "alpha": ALPHA,
            "traj": {f: getattr(ttraj, f) for f in
                     ("indices", "policy", "actions", "rewards", "values")}}
    cases["per_rank"] = {
        "kind": "train", "tree_dir": tree_dir, "steps": 2, "seed": 0,
        "cfg": torch_config.RNaDConfig(**CFG).to_json(),
        "net": torch_config.NetConfig(**NETS["mlp"]).to_json()}
    clusters = {}
    for world, names in ((2, ("mlp", "equinet", "convnet", "per_rank")),
                         (4, ("mlp", "equinet"))):
        out = root / f"world{world}"
        out.mkdir()
        torch.save({n: cases[n] for n in names}, out / "cases.pt")
        mpc.spawn(world, ["--cases", str(out / "cases.pt"), "--out",
                          str(out)], TIMEOUT, device="cpu",
                  module="tests.torch_dist_worker")
        clusters[world] = [torch.load(out / f"rank{r}.pt",
                                      weights_only=True)
                           for r in range(world)]
    return found, clusters


def _assert_metrics(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **METRIC_TOL,
                                   err_msg=f"{what}: metric {k}")


def _assert_weights(got, want, zero, what):
    for name, mask in zero.items():
        tol = torch.where(mask, 2 * LR, WEIGHT_ATOL)
        d = (got[name] - want[name]).abs()
        assert (d <= tol).all(), f"{what}: {name} off by {float(d.max())}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["mlp", "equinet"])
def test_learn_step_matches_one_rank_and_rnad_tpu(learn_cases, kind, world):
    found, clusters = learn_cases
    metrics1, weights1, zero = found[kind]["one_rank"]
    ranks = clusters[world]
    for r, res in enumerate(ranks):
        got = res[kind]
        _assert_metrics(got["metrics"], metrics1, f"rank {r} vs one rank")
        _assert_weights(got["state_dict"], weights1, zero,
                        f"rank {r} vs one rank")
        for k, v in got["state_dict"].items():  # replicated, bitwise
            assert torch.equal(v, ranks[0][kind]["state_dict"][k]), k
    # rnad_tpu's shard_map update on 8 devices, the same weights and lanes
    jmetrics, jparams = found[kind]["rnad_tpu"]
    mine, mine_w, _ = found[kind].get("one_rank_jax_solves",
                                      (ranks[0][kind]["metrics"],
                                       ranks[0][kind]["state_dict"], None))
    _assert_metrics(mine, jmetrics, "port vs rnad_tpu")
    _assert_weights(mine_w, _to_torch_net(kind, jparams).state_dict(), zero,
                    "port vs rnad_tpu")


def test_per_rank_stream_step_keeps_weights_replicated(learn_cases):
    """make_shard_map_train_step (test_shard_map_explicit_collectives):
    each rank rolls out its own stream; the losses are global and finite
    and the weights stay bitwise identical on every rank."""
    _, clusters = learn_cases
    ranks = [res["per_rank"] for res in clusters[2]]
    assert all(r["total_steps"] == 2 for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(np.isfinite(ranks[0]["losses"]))
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


def test_convnet_batchnorm_statistics_combined(learn_cases, small_tree):
    """A ConvNet's BatchNorm under the per-rank path
    (test_shard_map_convnet_bn_stats_combined): each rank normalizes over
    its own lanes, and the running statistics every rank carries are the
    mean over the lane slices of the one-rank learner's, and rnad_tpu's on
    a 2-device mesh."""
    found, clusters = learn_cases
    ranks = [res["convnet"]["state_dict"] for res in clusters[2]]
    tree = torch_tree(small_tree)
    packed = torch_stepping.make_packed_tables(tree)
    net = found["convnet"]["tnet"]
    per = []
    for r in range(2):
        state = torch_rnad.init_train_state(copy.deepcopy(net),
                                            torch.Generator())
        lanes = slice(r * B // 2, (r + 1) * B // 2)
        torch_rnad.learn_loss(state, packed,
                              lane_slice(found["convnet"]["traj"], lanes),
                              ALPHA, torch_config.RNaDConfig(**CFG))
        per.append(dict(state.net.named_buffers()))
    jax_bn = _to_torch_net("convnet", found["convnet"]["rnad_tpu"][1])
    buffers = dict(jax_bn.named_buffers())
    assert buffers
    for name, from_jax in buffers.items():
        want = (per[0][name] + per[1][name]) / 2
        for r, sd in enumerate(ranks):
            torch.testing.assert_close(sd[name], want, rtol=1e-5,
                                       atol=1e-7, msg=f"rank {r} {name}")
        assert torch.equal(ranks[0][name], ranks[1][name]), name
        torch.testing.assert_close(ranks[0][name], from_jax, rtol=1e-5,
                                   atol=1e-6, msg=f"rnad_tpu {name}")


@pytest.fixture(scope="module")
def one_rank_run(tmp_path_factory):
    """The straight one-rank global-stream run: 4 steps, step 0's lanes."""
    traj_dir = tmp_path_factory.mktemp("single_traj")
    return mpc.run_single(4, B, 7, device="cpu", timeout=TIMEOUT,
                          traj_out=str(traj_dir)), traj_dir


def test_global_stream_two_ranks_equal_one(one_rank_run, tmp_path):
    """runtime.make_sharded_train_step on 2 ranks: each rank's step-0
    lanes are the one-rank run's (indices, actions, rewards and policy
    equal), and 3 steps give its losses and checksum within rtol 1e-4 on
    weights that are bitwise equal on both ranks."""
    single, single_dir = one_rank_run
    multi = mpc.run_cluster(2, 3, B, 7, device="cpu", timeout=TIMEOUT,
                            traj_out=str(tmp_path))
    assert multi["num_processes"] == 2
    whole = np.load(single_dir / "rank0.npz")
    for r in range(2):
        part = np.load(tmp_path / f"rank{r}.npz")
        lanes = slice(r * B // 2, (r + 1) * B // 2)
        for field in ("indices", "actions", "rewards", "policy"):
            np.testing.assert_array_equal(part[field],
                                          whole[field][:, lanes],
                                          err_msg=f"rank {r} {field}")
    np.testing.assert_allclose(multi["losses"], single["losses"][:3],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(multi["param_checksum"],
                               single["checksums"][2], rtol=1e-4)
    assert len({r["param_digest"] for r in multi["ranks"]}) == 1


def test_resume_across_rank_counts(one_rank_run):
    """Saved by 2 ranks after 2 steps, resumed by 4 for 2 more: the
    losses are the straight one-rank run's within rtol 1e-4."""
    single, _ = one_rank_run
    phase1, phase2 = mpc.run_resume_across(2, 2, 4, 2, B, 7, device="cpu",
                                           timeout=TIMEOUT)
    assert phase1["num_processes"] == 2 and phase2["num_processes"] == 4
    assert phase2["total_steps"] == 4
    np.testing.assert_allclose(phase1["losses"], single["losses"][:2],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(phase2["losses"], single["losses"][2:],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(phase2["param_checksum"],
                               single["param_checksum"], rtol=1e-4)


GROUP = torch_mesh.DataGroup(rank=0, world=2, device=torch.device("cpu"))


def test_lanes_must_divide():
    with pytest.raises(ValueError, match="must divide over 2"):
        GROUP.lanes(65)
    assert GROUP.lanes(64) == slice(0, 32)
    assert torch_mesh.DataGroup(1, 4, torch.device("cpu")).lanes(64) == \
        slice(16, 32)


def test_local_noise_takes_both_seat_blocks():
    """A rank's noise is its lanes of each seat block of g_act (2B, A) and
    of the lift's eps, and its lanes of g_chance (B, T)."""
    g_act = torch.arange(16.0).reshape(8, 2)  # B = 4
    g_ch = torch.arange(8.0).reshape(4, 2)
    eps = torch.arange(8.0).reshape(8, 1, 1, 1)
    act, ch, e = runtime.local_noise((g_act, g_ch, eps), slice(2, 4), 4)
    assert act[:, 0].tolist() == [4.0, 6.0, 12.0, 14.0]
    assert ch.tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert e.reshape(-1).tolist() == [2.0, 3.0, 6.0, 7.0]
