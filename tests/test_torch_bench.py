"""The port's benchmark programs (rnad_tpu_torch/bench.py and
bench_suite.py) against bench.py and tools/bench_suite.py.

- The trees: bench.py's demo tree (numpy generator) and the suite's demo
  and big trees (native generator; the big one cut to depth_bound 4, as
  tests/test_torch_native_tree.py cuts it) hash as rnad_tpu's do.
- The rollout's measured quantities: on the demo tree at 64 lanes, from
  rnad_tpu's weights and noise, the port's rollout (kernel K1's route; its
  plain version on the CPU) plays rnad_tpu's episodes, and ``bench.
  measured`` gives what bench.py's expressions give on rnad_tpu's
  trajectory: the reward sum and the lane signature's std (a population
  std, as ``jnp.std``), within 1e-6.
- The product: one step of bench.py's bfloat16 configuration at 64 lanes
  against rnad_tpu's step run op by op (``jax.disable_jit``; compiled on
  the CPU, XLA keeps bfloat16 chains in float32), at the tolerances of
  tests/test_torch_nets_depth_dtype.py: weights within 1e-6 (2 lr where
  rnad_tpu's gradient is 0 but for rounding), losses rtol 1e-5.
- The iteration rules are the tools' formulas; with them patched to 2
  both programs run end to end on the CPU, print the JAX programs' metric
  names (less ``vs_baseline``, plus ``device`` and ``power_limit_w``) and
  label every row "cpu"; without a card and without ``--cpu`` they exit
  nonzero before printing a row.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.config import ShapingRule as JaxRule
from rnad_tpu.config import TreeConfig as JaxTreeConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.env import tree as jax_tree_lib
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch import bench, bench_suite
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.env import tree as torch_tree_lib
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.test_torch_nets_depth_dtype import (_assert_close,
                                               _assert_metrics_close)
from tests.torch_parity import (rollout_noise, torch_mlp, torch_tree,
                                train_step_noise)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64
# bench.py:32-36 and tools/bench_suite.py:111-122
DEMO = dict(max_actions=3, max_transitions=2, transition_threshold=0.3,
            depth_bound=4, depth_bound_rule=JaxRule(delta=-1,
                                                    stochastic_delta=-2,
                                                    stochastic_prob=0.5))
BIG4 = dict(max_actions=5, max_transitions=2, transition_threshold=0.25,
            depth_bound=4, depth_bound_rule=JaxRule(delta=-1,
                                                    stochastic_delta=-2,
                                                    stochastic_prob=0.55))
# bench.py:123-128
PRODUCT = dict(eta=0.2, bounds=(10**9,), delta_m=(10**9,), lr=5e-4,
               gamma_averaging=0.001, logit_clip=2.0, fuse_net_passes="auto",
               frozen_net_dtype="bfloat16")
BENCH_KEYS = {"metric", "value", "unit", "rollout_batch", "rollout_rates",
              "train_updates_per_s", "train_env_steps_per_s", "device",
              "power_limit_w"}
SUITE_METRICS = ["tree_generation", "rollout_env_steps_per_s",
                 "rollout_fused_turn_env_steps_per_s", "train_steps_per_s",
                 "train_env_steps_per_s", "train_steps_per_s_bf16",
                 "train_env_steps_per_s_bf16", "nashconv_eval"]


@pytest.fixture
def jax_native_loaded(monkeypatch):
    """rnad_tpu's native library loaded in this process.  rnad_tpu builds
    it in place (``rnad_tpu/native.py::_build``) the first time a process
    asks for it, and a process that loads it while another is still
    writing it gives up for the rest of its life (``_load_failed``): from
    then on rnad_tpu's numpy generator solves its levels with the numpy
    simplex, whose values round otherwise (another content hash), and its
    native generator raises.  Test workers that start together race so, and
    the worker that lost fails here for what an earlier file did.  The
    library is whole by now, so the loader gets one more try."""
    from rnad_tpu import native as jax_native

    if jax_native._load_failed:
        monkeypatch.setattr(jax_native, "_load_failed", False)
    assert jax_native.get_solver_lib() is not None


@pytest.mark.parametrize("which", ["bench", "suite_demo", "suite_big4"])
def test_trees_hash_as_rnad_tpus(which, jax_native_loaded):
    if which == "bench":
        got = torch_tree_lib.generate_tree(bench.TREE_CONFIG, seed=0,
                                           device="cpu")
        want = jax_tree_lib.generate_tree(JaxTreeConfig(**DEMO), seed=0)
    else:
        name, jcfg = {"suite_demo": ("demo", DEMO),
                      "suite_big4": ("big", BIG4)}[which]
        cfg = bench_suite.TREES[name]
        if name == "big":
            assert cfg.depth_bound == 6
            cfg = dataclasses.replace(cfg, depth_bound=4)
        got = torch_tree_lib.generate_tree_native(cfg, seed=0, device="cpu")
        want = jax_tree_lib.generate_tree_native(JaxTreeConfig(**jcfg),
                                                 seed=0)
    assert (got.hash, got.size, got.max_depth) == (want.hash, want.size,
                                                   want.max_depth)


@pytest.fixture(scope="module")
def demo_rollouts():
    """rnad_tpu's rollout as bench.py runs it (the rows-actor,
    policy_minor) and the port's as bench.py's counterpart runs it, from
    the same weights and noise."""
    tree = jax_tree_lib.generate_tree(JaxTreeConfig(**DEMO), seed=0)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=3,
                                       width=256))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(0), 3)
    packed = jax_stepping.make_packed_tables(tree)
    key = jax.random.PRNGKey(5)
    want = jax_engine.rollout(
        tree, lambda vs, obs: jax_nets.apply_eval(net, vs, obs), variables,
        key, B, tree.max_depth, packed,
        rows_actor=jax_engine.make_mlp_rows_actor(net, packed),
        policy_minor=True)
    ttree = torch_tree(tree)
    noise = rollout_noise(key, B, 3, tree.max_transitions, tree.max_depth)
    tnet = torch_mlp(variables["params"], 3, 256)
    assert torch_engine.uses_fused_turn(tnet, "auto")
    init = torch.ones((B,), dtype=torch.int32)
    got = torch_engine.rollout_from(
        ttree, torch_stepping.make_packed_tables(ttree), tnet, init,
        ttree.max_depth, noise=noise, rows_actor="auto")
    return tree.max_depth, want, got


def test_rollout_measures_equal_rnad_tpus(demo_rollouts):
    turns, want, got = demo_rollouts
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # bench.py:69 and :90-91
    t_weights = jnp.arange(1.0, 2 * turns + 1.0)[:, None]
    want_sum = float(want.rewards.sum())
    want_std = float(jnp.std((want.rewards * t_weights).sum(0)))
    weights = bench.signature_weights(got.num_half_steps, "cpu")
    np.testing.assert_array_equal(weights.numpy(), np.asarray(t_weights))
    got_sum, got_std = bench.measured(got, weights)
    assert want_std > 0.1  # lanes play different episodes
    np.testing.assert_allclose(float(got_sum), want_sum, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got_std), want_std, rtol=0, atol=1e-6)


def test_self_checks_raise():
    T = 8

    def fake(rewards):
        return lambda: torch_engine.Trajectory(
            indices=torch.ones((T, B), dtype=torch.int32),
            policy=torch.full((T, B, 3), 1 / 3),
            actions=torch.zeros((T, B), dtype=torch.int32),
            rewards=rewards, values=torch.zeros((T, B)))

    rewards = torch.zeros((T, B))
    rewards[1] = torch.linspace(-1, 1, B)
    dt, traj = bench.time_rollouts(fake(rewards), 2)
    assert dt > 0 and traj.batch_size == B
    same = torch.zeros((T, B))
    same[3] = 0.5  # every lane plays one episode
    with pytest.raises(AssertionError, match="lane collapse"):
        bench.time_rollouts(fake(same), 2)
    with pytest.raises(AssertionError, match="mean return"):
        bench.time_rollouts(fake(rewards + 3.0), 2)


def test_product_step_matches_rnad_tpus_op_by_op():
    assert bench.TRAIN_CONFIG == torch_config.RNaDConfig(batch_size=32768,
                                                          **PRODUCT)
    assert bench.TRAIN_NET_CONFIG == torch_config.NetConfig(
        type="MLP", max_actions=3, width=256, compute_dtype="bfloat16")
    tree = jax_tree_lib.generate_tree(JaxTreeConfig(**DEMO), seed=0)
    cfg = RNaDConfig(batch_size=B, **PRODUCT)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=3, width=256,
                                       compute_dtype="bfloat16"))
    step, rollout_jit, _, _ = jax_rnad.make_rnad_fns(net, tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(2), 3, cfg)
    with jax.disable_jit():
        new, metrics = step(state, jnp.float32(bench.ALPHA))
        # the step's own rollout, through the split program
        _, traj = rollout_jit(state)
        aux = {k: v for k, v in state.variables.items() if k != "params"}
        args = (aux, net, state.variables_target, state.variables_reg,
                state.variables_reg_, jax_stepping.make_packed_tables(tree),
                traj, jnp.float32(bench.ALPHA), cfg)
        grads = jax.grad(lambda p: jax_rnad.learn_loss(p, *args)[0])(
            state.variables["params"])
    # a bfloat16 gradient sums terms rounded to 2^-8 (bf16's unit
    # roundoff): an element below twice that of its leaf's largest has no
    # determined sign, and Adam with b1 = 0 steps it by lr either way (the
    # policy head's bias gradients cancel over the actions: one is 0 but
    # for rounding)
    zero = jax.tree.map(lambda g: np.abs(np.asarray(g, np.float32))
                        < 2.0**-7 * np.abs(np.asarray(g, np.float32)).max(),
                        grads)

    ttree = torch_tree(tree)
    tnet = torch_nets.build_net(bench.TRAIN_NET_CONFIG)
    tnet.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, state.variables["params"])))
    tstate = torch_rnad.init_train_state(tnet, torch.Generator())
    tcfg = dataclasses.replace(bench.TRAIN_CONFIG, batch_size=B)
    assert not torch_engine.uses_fused_turn(tnet, tcfg.rollout_rows_actor)
    assert torch_rnad.resolve_fuse_mode(tnet, tcfg) == "heads"
    tstep = torch_rnad.make_train_step(
        ttree, torch_stepping.make_packed_tables(ttree), tcfg)
    noise = train_step_noise(state.key, B, 3, tree.max_transitions,
                             tree.max_depth)
    _, tmetrics = tstep(tstate, bench.ALPHA, noise)
    _assert_metrics_close(tmetrics, metrics)
    _assert_close(torch_nets.params_to_flax(tstate.net),
                  new.variables["params"], 1e-6, zero, cfg.lr)
    _assert_close(torch_nets.params_to_flax(tstate.net_target),
                  new.variables_target["params"], 1e-6, zero, cfg.lr)


def test_train_step_returns_its_trajectory():
    """bench_suite times ``make_train_step``'s step, asking it for the
    trajectory it rolled out: the step is the same, and the trajectory is
    the rollout's from the same noise."""
    tree = torch_tree_lib.generate_tree(bench.TREE_CONFIG, seed=0,
                                        device="cpu")
    packed = torch_stepping.make_packed_tables(tree)
    cfg = torch_config.RNaDConfig(batch_size=B, eta=0.2, bounds=(1,),
                                  delta_m=(1,), lr=1e-3)
    net_cfg = torch_config.NetConfig(type="MLP", max_actions=3, width=16)
    step = torch_rnad.make_train_step(tree, packed, cfg)
    noise = [torch_engine.turn_noise(B, 3, tree.max_transitions,
                                     torch.Generator().manual_seed(7 + t),
                                     "cpu")
             for t in range(tree.max_depth)]
    runs = []
    for with_trajectory in (False, True):
        state = torch_rnad.init_train_state(
            torch_nets.build_net(net_cfg, torch.Generator().manual_seed(0)),
            torch.Generator().manual_seed(1))
        out = step(state, 0.5, noise, with_trajectory=with_trajectory)
        assert len(out) == 2 + with_trajectory and out[0] is state
        runs.append((state, out))
    (plain, (_, metrics)), (kept, (_, kept_metrics, traj)) = runs
    assert set(kept_metrics) == set(metrics)
    for k in metrics:
        torch.testing.assert_close(kept_metrics[k], metrics[k], rtol=0,
                                   atol=0)
    for a, b in zip(plain.net.parameters(), kept.net.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    state = torch_rnad.init_train_state(
        torch_nets.build_net(net_cfg, torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1))
    want = torch_rnad.rollout(state, tree, packed, cfg, noise)
    for f in ("indices", "actions", "rewards", "policy", "values"):
        torch.testing.assert_close(getattr(traj, f), getattr(want, f),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("batch,tree_size", [(4096, 306), (32768, 65440),
                                             (131072, 785768)])
def test_iteration_rules_are_the_tools(batch, tree_size):
    # bench.py:78; tools/bench_suite.py:325, :417, :536
    assert bench.rollout_iters(batch) == (1 << 26) // batch
    assert bench_suite.rollout_iters(batch) == max(4, min(1024, (1 << 26)
                                                          // batch))
    assert bench_suite.train_iters(batch) == max(4, min(1000, (1 << 23)
                                                        // batch))
    assert bench_suite.nashconv_iters(tree_size) == max(
        4, min(64, (1 << 21) // tree_size))


@pytest.fixture
def two_iterations(monkeypatch):
    """Both programs at 2 iterations of everything and small batches."""
    monkeypatch.setattr(bench, "ROLLOUT_BATCHES", (64, 128))
    monkeypatch.setattr(bench, "TRAIN_CONFIG", dataclasses.replace(
        bench.TRAIN_CONFIG, batch_size=64))
    monkeypatch.setattr(bench, "TRAIN_STEPS", 2)
    monkeypatch.setattr(bench, "rollout_iters", lambda b: 2)
    for rule in ("rollout_iters", "train_iters", "nashconv_iters"):
        monkeypatch.setattr(bench_suite, rule, lambda n: 2)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_bench_runs_on_the_cpu(two_iterations, capsys):
    line = bench.main(["--cpu"])
    assert _lines(capsys) == [line]
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "env_half_steps_per_s_per_chip"
    assert set(line["rollout_rates"]) == {"64", "128"}
    assert line["rollout_batch"] in (64, 128)
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)
    assert line["train_env_steps_per_s"] > line["train_updates_per_s"] > 0


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_bench_suite_runs_on_the_cpu(two_iterations, capsys, net):
    argv = ["--cpu", "--batches", "64", "--net", net, "--lookup", "pallas",
            "--max-lanes-per-chunk", "16"]
    rows = bench_suite.main(argv + ["--fused-turn"] * (net == "mlp"))
    assert _lines(capsys) == rows
    want = [m for m in SUITE_METRICS
            if net == "mlp" or m != "rollout_fused_turn_env_steps_per_s"]
    assert [r["metric"] for r in rows] == want
    for r in rows:
        assert (r["device"], r["power_limit_w"], r["lookup"]) == (
            "cpu", None, "K2")
        assert np.isfinite(r["value"]) and "pct_of_roof" not in r
    train = [r for r in rows if r["metric"].startswith("train_")]
    assert {r["method"] for r in train} == {"back-to-back"}
    assert [r["dtype"] for r in train] == ["float32"] * 2 + ["bfloat16"] * 2
    assert rows[0]["clock"] == "host"
    # the fused-turn row's route raises where K1 cannot take the net
    tree = torch_tree_lib.generate_tree_native(bench_suite.TREES["demo"],
                                               device="cpu")
    roll = bench.rollout_fn(tree, torch_stepping.make_packed_tables(tree),
                            torch_nets.build_net(bench_suite.net_config(
                                net, 3)), 4, None, rows_actor="on")
    if net == "conv":
        with pytest.raises(ValueError, match="requires an MLP"):
            roll()
    else:
        assert roll().batch_size == 4


def test_phase13_predicts_the_launches(two_iterations, monkeypatch,
                                       capsys):
    """``chip_smoke.py`` phase 13 holds each program's kernel launches to
    a count it derives from the code; on the CPU the wrappers run their
    plain versions, which count the same calls."""
    import chip_smoke
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib

    calls = {"k1": 0, "k1_bf16": 0, "k2": 0}
    turn, lookup = fused_turn_lib.fused_turn, lookup_lib.lookup

    def counted_turn(*args, **kw):
        calls["k1_bf16" if args[1].dtype == torch.bfloat16 else "k1"] += 1
        return turn(*args, **kw)

    def counted_lookup(*args, **kw):
        calls["k2"] += 1
        return lookup(*args, **kw)

    monkeypatch.setattr(fused_turn_lib, "fused_turn", counted_turn)
    monkeypatch.setattr(lookup_lib, "lookup", counted_lookup)
    # the big tree at depth_bound 6 is too large for a CPU test
    monkeypatch.setitem(bench_suite.TREES, "big", dataclasses.replace(
        bench_suite.TREES["big"], depth_bound=4))
    bench.main(["--cpu"])
    turns = bench.TREE_CONFIG.depth_bound
    assert calls == {
        "k1": turns * sum(bench.WARM_ROLLOUTS + bench.rollout_iters(b)
                          for b in bench.ROLLOUT_BATCHES),
        "k1_bf16": 0,
        # K2 a generic turn; no regather: the rollout stores the
        # observations (store_rollout_obs)
        "k2": turns * (bench.WARM_STEPS + bench.TRAIN_STEPS)}
    for argv in chip_smoke.SUITE_RUNS:
        argv = [a if a != "32768" else "64" for a in argv]
        calls.update(k1=0, k1_bf16=0, k2=0)
        rows = bench_suite.main(["--cpu"] + argv)
        assert [r["metric"] for r in rows] == chip_smoke.suite_rows(argv)
        assert calls == chip_smoke.suite_launches(argv, rows), argv
        assert sum(calls.values()) > 0
    capsys.readouterr()


def test_refusals(monkeypatch, capsys, tmp_path):
    with pytest.raises(SystemExit, match="--net mlp"):
        bench_suite.main(["--cpu", "--net", "conv", "--fused-turn"])
    with pytest.raises(SystemExit, match="--write-doc"):
        bench_suite.main(["--cpu", "--write-doc"])
    # without a card and without --cpu: nonzero, before any row
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_suite.main):
        with pytest.raises(SystemExit, match="--cpu") as exc:
            main([])
        assert exc.value.code not in (None, 0)
    assert capsys.readouterr().out == ""


def test_write_doc(tmp_path):
    labels = {"device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
              "lookup": "K2"}
    rows = [{"metric": "tree_generation", "value": 0.0123, "unit": "s",
             **labels},
            {"metric": "rollout_env_steps_per_s", "value": 1.5e8,
             "unit": "steps/s", "batch": 32768, "pct_of_roof": 12.5,
             "pct_of_hbm": 3.25, "bound": "ops", **labels}]
    path = tmp_path / "doc" / "BENCH_SUITE.md"
    bench_suite.write_doc(rows, str(path), ["--tree", "big"])
    text = path.read_text().splitlines()
    assert text[0] == ("# Performance of rnad_tpu_torch (NVIDIA H100 80GB "
                       "HBM3, 700.0 W power limit, 1 card)")
    assert "`python3 -m rnad_tpu_torch.bench_suite --tree big`" in text[2]
    assert text[-2:] == [
        "| tree_generation | - | 0.012 | s | - | - | - |",
        "| rollout_env_steps_per_s | 32768 | 150,000,000.000 | steps/s "
        "| 12.500 | 3.250 | ops |"]
    assert bench_suite.DOC_PATH == os.path.join(
        REPO, "docs", "port_runs", "bench", "BENCH_SUITE.md")


def test_modules_import_no_jax():
    code = ("import sys\n"
            "import rnad_tpu_torch.bench, rnad_tpu_torch.bench_suite\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'optax',\n"
            "                                    'rnad_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
