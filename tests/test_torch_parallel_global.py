"""The global-stream data axis (``rnad_tpu_torch/parallel/runtime.py``) on
the two paths it gained: the ConvNet's BatchNorm over the global batch and
the buffered step's exchange of collated lanes.

Every multi-rank case runs in spawned CPU processes over gloo (one thread
each, a time limit on every cluster; ``tests/torch_dist_worker.py``):

* a ConvNet learner update on a fixed trajectory with the global
  BatchNorm, on 2 and 4 ranks, against the port's one-rank ``learn_step``
  and against ``rnad_tpu``'s GSPMD ``learn_jit`` on 2 of the conftest's
  virtual devices, from the same converted weights and trajectory: metrics
  within rtol 2e-5 / atol 1e-6, weights within 2e-6, running statistics
  within 1e-6 of ``rnad_tpu``'s ``batch_stats`` and bitwise equal across
  the ranks;
* the differentiable all-reduce (``DataGroup.global_sum_grad``): a
  global-BatchNorm forward's gradients with respect to its inputs and its
  scale, against one rank's on the concatenated batch, also where one
  rank's samples are all masked;
* the exchange (``TrajectoryBuffer.sample`` under a group) on 2 and 4
  ranks against one rank's ``sample`` at each rank's positions, bitwise;
* one buffered learner step on 2 ranks against ``rnad_tpu``'s sharded
  ``learn_jit.sampled`` on a 2-device mesh, fed the same plan from equal
  ``np.random.Generator``s.
"""

import jax
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import buffer as jax_buffer
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.parallel import mesh as jax_mesh
from rnad_tpu.parallel import runtime as jax_runtime
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch import multiprocess_check as mpc
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.learn import buffer as torch_buffer
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.utils import checkpoint
from tests.test_torch_parallel import (A, ALPHA, B, CFG, NETS, TIMEOUT,
                                       _assert_metrics, _assert_weights,
                                       _one_rank, _to_torch_net)
from tests.torch_parity import torch_trajectory, torch_tree

BUFFERED = dict(n_batches_per_buffer=4, buffer_mod=2)
STATS_ATOL = 1e-6
# the exchange's buffers: slot sizes (global lanes) and the batch drawn
SAMPLE_CASES = {
    "one_full_slot": ([64], 64),
    "two_slots_obs": ([64, 64], 64),
    "unequal_fill": ([64, 32, 64], 64),
    "short_slot": ([64, 8, 64, 64], 64),  # 8 < its share of 16
}


def _gspmd(net, small_tree, cfg):
    """rnad_tpu's GSPMD train-step family on 2 of the virtual devices."""
    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    (_, _, learn_jit, _), _, place_state = jax_runtime.make_sharded_rnad_fns(
        net, small_tree, cfg, mesh=mesh)
    return learn_jit, place_state


def _convnet_case(small_tree, tree_dir):
    kw = NETS["convnet"]
    net = jax_nets.build_net(NetConfig(**kw))
    cfg = RNaDConfig(**CFG)
    _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state0 = jax_rnad.init_train_state(net, jax.random.PRNGKey(0), A, cfg)
    _, traj = rollout_jit(state0)
    learn_jit, place_state = _gspmd(net, small_tree, cfg)
    new, metrics = learn_jit(place_state(state0), traj, ALPHA)
    tnet = _to_torch_net("convnet", state0.variables)
    ttraj = torch_trajectory(traj, keep_obs=False)
    tcfg = torch_config.RNaDConfig(**CFG)
    found = {"one_rank": _one_rank(tnet, torch_tree(small_tree), tcfg, ttraj),
             "rnad_tpu": ({k: float(v) for k, v in metrics.items()},
                          _to_torch_net("convnet", new.variables))}
    case = {"kind": "learn", "batch_norm": "global", "tree_dir": tree_dir,
            "cfg": tcfg.to_json(),
            "net": torch_config.NetConfig(**kw).to_json(),
            "state_dict": tnet.state_dict(), "alpha": ALPHA,
            "traj": {f: getattr(ttraj, f) for f in
                     ("indices", "policy", "actions", "rewards", "values")}}
    return found, case


def _bn_cases():
    """A BatchNorm's inputs, mask and output cotangent (16 samples); in
    "masked" only samples 0-3 are valid, so every rank but rank 0 (of 2
    or 4) holds masked samples only."""
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bn = torch_nets.MaskedBatchNorm(3)
    with torch.no_grad():
        bn.scale.copy_(f(3))
        bn.bias.copy_(f(3))
    x, g = f(16, 3, 3, 3), f(16, 3, 3, 3)
    all_valid = torch.ones(16)
    masked = (torch.arange(16) < 4).float()
    return {name: {"kind": "bn_grad", "x": x, "g": g, "mask": mask,
                   "bn": bn.state_dict()}
            for name, mask in (("all_valid", all_valid), ("masked", masked))}


def _bn_one_rank(case):
    bn = torch_nets.MaskedBatchNorm(case["x"].shape[1])
    bn.load_state_dict(case["bn"])
    x = case["x"].clone().requires_grad_(True)
    y = bn(x, train=True, mask=case["mask"])
    grad_x, grad_scale = torch.autograd.grad((y * case["g"]).sum(),
                                             [x, bn.scale])
    return {"grad_x": grad_x, "grad_scale": grad_scale, "y": y.detach(),
            "state_dict": bn.state_dict()}


def _slot(seed, size, obs):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    T = 6
    slot = {"indices": torch.from_numpy(
                rng.integers(0, 50, (T, size)).astype(np.int32)),
            "policy": f(T, size, A),
            "actions": torch.from_numpy(
                rng.integers(0, A, (T, size)).astype(np.int32)),
            "rewards": f(T, size), "values": f(T, size)}
    slot["rewards"][0, 0] = -0.0  # arrives as +0.0, which torch.equal takes
    if obs:
        slot["obs"] = f(T, size, 5, A, A)
    return slot


def _sample_case(name):
    sizes, batch = SAMPLE_CASES[name]
    slots = [_slot(10 * i + len(sizes), n, name == "two_slots_obs")
             for i, n in enumerate(sizes)]
    case = {"kind": "sample", "slots": slots, "batch_size": batch,
            "rng_seed": 11, "draws": 2}
    buf = torch_buffer.TrajectoryBuffer(len(slots))
    for s in slots:
        buf.append(torch_engine.Trajectory(**s))
    rng = np.random.default_rng(11)
    want = [buf.sample(batch, rng) for _ in range(2)]
    return case, want


def _buffered_case(small_tree, tree_dir):
    """Three of rnad_tpu's rollouts in a buffer, its plan from
    default_rng(7) and its sharded ``learn_jit.sampled`` on 2 devices;
    the port's one-rank update on the same collated batch."""
    kw = NETS["mlp"]
    net = jax_nets.build_net(NetConfig(**kw))
    cfg = RNaDConfig(**CFG, **BUFFERED)
    _, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(2), A, cfg)
    buf = jax_buffer.TrajectoryBuffer(4)
    for _ in range(3):
        state, traj = rollout_jit(state)
        buf.append(traj)
    slots, lanes = buf.plan(B, np.random.default_rng(7))
    learn_jit, place_state = _gspmd(net, small_tree, cfg)
    new, metrics = learn_jit.sampled(place_state(state), slots, lanes, ALPHA)
    tnet = _to_torch_net("mlp", state.variables)
    tslots = [torch_trajectory(s, keep_obs=False) for s in buf.slots]
    tcfg = torch_config.RNaDConfig(**CFG, **BUFFERED)
    collated = torch_buffer.collate_slots(
        [torch_trajectory(s, keep_obs=False) for s in slots],
        [torch.from_numpy(np.array(x)) for x in lanes])
    found = {"one_rank": _one_rank(tnet, torch_tree(small_tree), tcfg,
                                   collated),
             "rnad_tpu": ({k: float(v) for k, v in metrics.items()},
                          _to_torch_net("mlp", new.variables))}
    case = {"kind": "buffered_learn", "tree_dir": tree_dir,
            "cfg": tcfg.to_json(),
            "net": torch_config.NetConfig(**kw).to_json(),
            "state_dict": tnet.state_dict(), "alpha": ALPHA, "rng_seed": 7,
            "slots": [{k: v for k, v in vars(s).items() if torch.is_tensor(v)}
                      for s in tslots]}
    return found, case


@pytest.fixture(scope="module")
def clusters(small_tree, tmp_path_factory):
    """The expected values in process, then one spawned cluster of 2 and
    one of 4 ranks running every case."""
    root = tmp_path_factory.mktemp("parallel_global")
    tree_dir = checkpoint.save_tree(torch_tree(small_tree), "small",
                                    root=str(root / "trees"))
    found, cases = {}, {}
    found["convnet"], cases["convnet"] = _convnet_case(small_tree, tree_dir)
    found["buffered"], cases["buffered"] = _buffered_case(small_tree,
                                                          tree_dir)
    for name, case in _bn_cases().items():
        cases[f"bn_{name}"] = case
        found[f"bn_{name}"] = _bn_one_rank(case)
    for name in SAMPLE_CASES:
        cases[f"sample_{name}"], found[f"sample_{name}"] = _sample_case(name)
    out = {}
    for world in (2, 4):
        names = [n for n in cases if world == 2 or n != "buffered"]
        wdir = root / f"world{world}"
        wdir.mkdir()
        torch.save({n: cases[n] for n in names}, wdir / "cases.pt")
        mpc.spawn(world, ["--cases", str(wdir / "cases.pt"), "--out",
                          str(wdir)], TIMEOUT, device="cpu",
                  module="tests.torch_dist_worker")
        out[world] = [torch.load(wdir / f"rank{r}.pt", weights_only=True)
                      for r in range(world)]
    return found, out


def _assert_replicated(ranks, name):
    for r, res in enumerate(ranks[1:], 1):
        for k, v in res[name]["state_dict"].items():
            assert torch.equal(v, ranks[0][name]["state_dict"][k]), (r, k)


@pytest.mark.parametrize("world", [2, 4])
def test_global_batchnorm_learn_step(clusters, world):
    """A ConvNet learner update with the BatchNorm over the global batch
    (``learn_step``'s "global") equals one rank's on the whole batch and
    rnad_tpu's GSPMD step; the running statistics are equal on every rank
    (no averaging after the update)."""
    found, out = clusters
    metrics1, weights1, zero = found["convnet"]["one_rank"]
    ranks = out[world]
    _assert_replicated(ranks, "convnet")
    got = ranks[0]["convnet"]
    _assert_metrics(got["metrics"], metrics1, "ranks vs one rank")
    _assert_weights(got["state_dict"], weights1, zero, "ranks vs one rank")
    jmetrics, jnet = found["convnet"]["rnad_tpu"]
    _assert_metrics(got["metrics"], jmetrics, "ranks vs rnad_tpu")
    _assert_weights(got["state_dict"], jnet.state_dict(), zero,
                    "ranks vs rnad_tpu")
    stats = dict(jnet.named_buffers())
    assert stats
    for name, want in stats.items():
        for what, have in (("one rank", weights1[name]),
                           ("ranks", got["state_dict"][name])):
            torch.testing.assert_close(have, want, rtol=0, atol=STATS_ATOL,
                                       msg=f"{what} {name}")


@pytest.mark.parametrize("world,case", [(2, "all_valid"), (2, "masked"),
                                        (4, "masked")])
def test_global_sum_grad_gradients(clusters, world, case):
    """The global BatchNorm's gradients with respect to each rank's inputs
    and (summed over the ranks) its scale equal one rank's on the whole
    batch, also where a rank's samples are all masked (its statistics,
    clamped after the sum, are the global ones)."""
    found, out = clusters
    want = found[f"bn_{case}"]
    ranks = out[world]
    _assert_replicated(ranks, f"bn_{case}")
    per = 16 // world
    for r, res in enumerate(ranks):
        got = res[f"bn_{case}"]
        lanes = slice(r * per, (r + 1) * per)
        for key, full in (("y", want["y"][lanes]),
                          ("grad_x", want["grad_x"][lanes]),
                          ("grad_scale", want["grad_scale"])):
            torch.testing.assert_close(got[key], full, rtol=1e-5,
                                       atol=1e-5, msg=f"rank {r} {key}")
        for k, v in want["state_dict"].items():
            torch.testing.assert_close(got["state_dict"][k], v, rtol=1e-6,
                                       atol=1e-7, msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(SAMPLE_CASES))
def test_sample_exchange_equals_one_rank(clusters, world, name):
    """``sample(batch, rng, group)`` on slots holding each rank's lanes is
    one rank's ``sample`` at the rank's positions, every field bitwise
    (``obs`` included), draw after draw from one generator."""
    found, out = clusters
    want = found[f"sample_{name}"]
    per = SAMPLE_CASES[name][1] // world
    for r, res in enumerate(out[world]):
        draws = res[f"sample_{name}"]["draws"]
        assert len(draws) == len(want)
        for d, (got, full) in enumerate(zip(draws, want)):
            fields = {k for k, v in vars(full).items() if torch.is_tensor(v)}
            assert set(got) == fields, (r, d)
            for k in fields:
                part = getattr(full, k)[:, r * per:(r + 1) * per]
                assert got[k].dtype == part.dtype, (r, d, k)
                assert torch.equal(got[k], part), (r, d, k)


def test_buffered_learn_step_matches_rnad_tpu(clusters):
    """One buffered learner step on 2 ranks (each rank's lanes of three
    rollouts, the exchange, then ``learn_step``) equals rnad_tpu's sharded
    ``learn_jit.sampled`` on a 2-device mesh and the port's one-rank step
    on the same collated batch."""
    found, out = clusters
    ranks = out[2]
    _assert_replicated(ranks, "buffered")
    got = ranks[0]["buffered"]
    metrics1, weights1, zero = found["buffered"]["one_rank"]
    _assert_metrics(got["metrics"], metrics1, "ranks vs one rank")
    _assert_weights(got["state_dict"], weights1, zero, "ranks vs one rank")
    jmetrics, jnet = found["buffered"]["rnad_tpu"]
    _assert_metrics(got["metrics"], jmetrics, "ranks vs rnad_tpu")
    _assert_weights(got["state_dict"], jnet.state_dict(), zero,
                    "ranks vs rnad_tpu")
