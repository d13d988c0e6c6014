"""The port's run store, resume, best checkpoint, reg_anchor="best" and
metric log (rnad_tpu_torch/utils/checkpoint.py, utils/logging.py and the
``RNaD`` lifecycle in learn/rnad.py), against rnad_tpu's where it has an
observable counterpart.

Resume is bit-exact: a run cut after three steps and resumed by a new
``RNaD`` on the same directory ends on the weights, Adam state, step count
and rollout generator state of the run that went straight through.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.utils import checkpoint as torch_checkpoint
from tests.torch_parity import torch_tree

A = 3
NETS = {
    "mlp": dict(max_actions=A, width=16),
    "equinet": dict(type="EquiNet", max_actions=A, channels=8, depth=2,
                    solver_iters=8, solver_prime=True),
    # BatchNorm statistics in the checkpoint, and the lift's noise drawn
    # from the rollout generator
    "convnet-lift": dict(type="ConvNet", max_actions=A, channels=4, depth=1),
}
LIFT = torch_config.ObsTransformConfig(kind="lift", channels=4, sigma=0.15)


def _run(tree, tmp_path, name="run", net="mlp", **kw):
    cfg = dict(batch_size=32, bounds=(2,), delta_m=(3,), lr=1e-3,
               gamma_averaging=0.01, nashconv_chunk_nodes=50)
    if net == "convnet-lift":
        cfg["obs_transform"] = LIFT
    cfg.update(kw)
    return torch_rnad.RNaD(tree, torch_config.RNaDConfig(**cfg),
                           torch_config.NetConfig(**NETS[net]),
                           directory_name=name, runs_root=str(tmp_path),
                           device="cpu")


def _state_tensors(state):
    out = [p for name in ("net", "net_target", "net_reg", "net_reg_")
           for p in getattr(state, name).state_dict().values()]
    return out + state.opt.mu + state.opt.nu + [state.generator.get_state()]


def _assert_states_equal(a, b):
    assert (a.total_steps, a.opt.count) == (b.total_steps, b.opt.count)
    for x, y in zip(_state_tensors(a), _state_tensors(b), strict=True):
        assert torch.equal(x, y)


class _Crash(Exception):
    pass


@pytest.mark.parametrize("net", sorted(NETS))
def test_resume_is_bit_exact(small_tree, tmp_path, net):
    """6 steps straight against 3 steps, a crash in the 4th (after the
    checkpoint (1, 0) it takes first) and a new RNaD that resumes there."""
    tree = torch_tree(small_tree)
    straight = _run(tree, tmp_path, "straight", net)
    straight.run(checkpoint_mod=1, log_mod=1)
    straight.final_eval()

    cut = _run(tree, tmp_path, "cut", net)
    step = cut.train_step
    calls = itertools.count()

    def crash_in_the_fourth(state, alpha):
        if next(calls) == 3:
            raise _Crash
        return step(state, alpha)

    cut.train_step = crash_in_the_fourth
    with pytest.raises(_Crash):
        cut.run(checkpoint_mod=1, log_mod=1)
    assert cut.state.total_steps == 3
    assert cut.store.latest() == (1, 0)

    resumed = _run(tree, tmp_path, "cut", net)
    resumed.run(checkpoint_mod=1, log_mod=1)
    resumed.final_eval()
    assert (resumed.m, resumed.n) == (straight.m, straight.n)
    _assert_states_equal(resumed.state, straight.state)
    evals = lambda r: [m["nashconv"] for _, m in r.history
                       if "nashconv" in m]
    assert evals(resumed) == evals(straight)  # the m = 1 eval and the final
    assert (resumed.store.load_best_meta()["nashconv"]
            == straight.store.load_best_meta()["nashconv"])


def test_checkpoint_round_trip_and_latest(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    run = _run(tree, tmp_path, net="equinet")
    run.run(max_updates=1, checkpoint_mod=2, log_mod=1)
    store = run.store
    assert store.exists() and store.latest() == (0, 2)
    params = store.load_params()
    assert set(params) == {"rnad", "net", "tree_hash", "seed",
                           "directory_name"}
    assert params["tree_hash"] == tree.hash
    assert params["net"] == run.net_config.to_json()
    # checkpoint (0, 2) holds the state before the third step
    loaded = store.load_checkpoint(0, 2, run._fresh_state())
    assert loaded.total_steps == loaded.opt.count == 2
    # an m-directory left empty by an interrupted save is skipped
    os.makedirs(os.path.join(store.directory, "7"))
    assert store.latest() == (0, 2)
    assert not any(f.endswith(".tmp")
                   for _, _, files in os.walk(store.directory)
                   for f in files)


def test_best_checkpoint_embeds_its_meta(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    run = _run(tree, tmp_path)
    run.initialize()
    store = run.store
    assert store.load_best_meta() is None and store.load_best(None) is None
    meta = {"nashconv": 0.25, "step": 0, "m": 0, "n": 0}
    store.save_best(run.state, meta)
    os.remove(os.path.join(store.directory, "best.json"))  # a mirror only
    assert store.load_best_meta() == meta
    with open(os.path.join(store.directory, "best.ckpt"), "rb") as f:
        assert f.read(len(torch_checkpoint._BEST_MAGIC)) == \
            torch_checkpoint._BEST_MAGIC
    state, got = store.load_best(run._fresh_state())
    assert got == meta
    _assert_states_equal(state, run.state)
    run.final_eval()  # 0.25 is a bar the untrained net does not beat
    assert store.load_best_meta() == meta
    store.save_best(run.state, dict(meta, nashconv=0.125))
    with open(os.path.join(store.directory, "best.json")) as f:
        assert json.load(f) == dict(meta, nashconv=0.125)


def test_resume_on_another_tree_raises(small_tree, tiny_tree, tmp_path):
    _run(torch_tree(small_tree), tmp_path, "x").initialize()
    other = torch_rnad.RNaD(
        torch_tree(tiny_tree), torch_config.RNaDConfig(batch_size=8),
        torch_config.NetConfig(max_actions=2, width=8), directory_name="x",
        runs_root=str(tmp_path), device="cpu")
    with pytest.raises(AssertionError, match="hash mismatch"):
        other.initialize()


def test_same_init_net_as(small_tree, tmp_path):
    tree = torch_tree(small_tree)
    first = _run(tree, tmp_path, "first")
    first.initialize()
    cfg = torch_config.RNaDConfig(batch_size=32)
    second = torch_rnad.RNaD(tree, cfg, torch_config.NetConfig(**NETS["mlp"]),
                             directory_name="second",
                             runs_root=str(tmp_path), seed=5,
                             use_same_init_net_as="first", device="cpu")
    second.initialize()
    for name in ("net", "net_target", "net_reg", "net_reg_"):
        for p, q in zip(getattr(second.state, name).parameters(),
                        first.state.net.parameters()):
            assert torch.equal(p, q)


SCRIPT = [0.5, 0.3, 0.4, 0.2, 0.6, 0.1]


def _record_anchors(run, is_best):
    """Wraps ``run._rotate_for_schedule`` to note after each update
    boundary whether pi_reg is the best checkpoint's target."""
    rotate = run._rotate_for_schedule
    seen = []

    def wrapped():
        rotate()
        seen.append(is_best(run))

    run._rotate_for_schedule = wrapped
    return seen


def test_reg_anchor_best_matches_rnad_tpu(small_tree, tmp_path):
    """One scripted sequence of eval values: both packages anchor pi_reg to
    the best target at the same boundaries and store the same best."""
    kw = dict(batch_size=32, bounds=(6,), delta_m=(1,), lr=1e-3,
              reg_anchor="best")
    jrun = jax_rnad.RNaD(small_tree, RNaDConfig(**kw),
                         NetConfig(max_actions=A, width=16),
                         directory_name="jax", runs_root=str(tmp_path))
    values = iter(SCRIPT)
    jrun.nashconv = lambda: next(values)
    jseen = _record_anchors(
        jrun, lambda r: (getattr(r, "_best_target", None) is not None
                         and r.state.variables_reg is r._best_target))
    jrun.run(checkpoint_mod=1, log_mod=1)
    jrun.final_eval()

    trun = _run(torch_tree(small_tree), tmp_path, "torch", **kw)
    values = iter(SCRIPT)
    trun.nashconv = lambda: next(values)
    tseen = _record_anchors(
        trun, lambda r: (getattr(r, "_best_target", None) is not None
                         and r.state.net_reg is r._best_target))
    trun.run(checkpoint_mod=1, log_mod=1)
    trun.final_eval()

    assert tseen == jseen and any(tseen) and not all(tseen)
    assert trun.store.load_best_meta() == jrun.store.load_best_meta()


def test_reg_anchor_best_resumes_its_anchor(small_tree, tmp_path):
    """A resumed "best" run reloads the anchor from best.ckpt."""
    tree = torch_tree(small_tree)
    kw = dict(bounds=(4,), delta_m=(1,), reg_anchor="best")
    first = _run(tree, tmp_path, "best", **kw)
    values = iter([0.2, 0.9])
    first.nashconv = lambda: next(values)
    first.run(max_updates=2, checkpoint_mod=1)
    best = first._best_target
    again = _run(tree, tmp_path, "best", **kw)
    again.nashconv = lambda: 0.95
    again.run(max_updates=1, checkpoint_mod=1)  # a worse eval: anchor
    for p, q in zip(again.state.net_reg.parameters(), best.parameters()):
        assert torch.equal(p, q)


def test_metrics_jsonl_keys_match_rnad_tpu(small_tree, tmp_path):
    kw = dict(batch_size=32, bounds=(2,), delta_m=(2,), lr=1e-3)
    jrun = jax_rnad.RNaD(small_tree, RNaDConfig(**kw),
                         NetConfig(max_actions=A, width=16),
                         directory_name="jax", runs_root=str(tmp_path))
    jrun.run(log_mod=1)
    jrun.final_eval()
    jrun.logger.finish()
    trun = _run(torch_tree(small_tree), tmp_path, "torch", **kw)
    trun.run(log_mod=1)
    trun.final_eval()
    trun.logger.finish()

    def lines(run):
        with open(os.path.join(run.store.directory, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = lines(trun), lines(jrun)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert all(np.isfinite(v) for r in got for v in r.values())
