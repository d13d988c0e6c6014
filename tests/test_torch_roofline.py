"""rnad_tpu_torch/roofline.py against tools/roofline.py (the TPU tool's
ideal products), against torch's own FLOP count of the port's learner and
rollout, and against hand counts of its bytes; K1's byte count
(``fused_turn.io_bytes``) against ``chip_smoke.py``'s former formula;
``annotate`` and ``profile_step.py``'s roofline rows on the CPU."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rnad_tpu_torch import profile_step, roofline
from rnad_tpu_torch.config import (NetConfig, RNaDConfig, ShapingRule,
                                   TreeConfig)
from rnad_tpu_torch.env import engine
from rnad_tpu_torch.env import tree as tree_lib
from rnad_tpu_torch.learn import buffer as buffer_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import fused_turn, stepping
from tools import roofline as tpu_roofline

T = 2  # chance outcomes a joint cell on every tree here


def _step(A, levels, B, W, dtype="float32", depth=1, **kw):
    return roofline.MLPStep(A=A, T=T, levels=levels, B=B, width=W,
                            depth=depth, dtype=dtype, frozen_dtype=dtype,
                            actor_dtype=dtype, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,levels,B,W", [(3, 4, 32768, 256),
                                          (5, 6, 32768, 256)])
def test_ideal_products_are_the_tpu_tools(A, levels, B, W, dtype):
    """The rollout's products are the TPU tool's generic-actor count and
    K1's ``operations``; the learner's, the frozen passes' and the
    backward's are the TPU tool's learner count less the first layer's
    input gradient (2 n din W a tower), which the TPU tool charges and
    autograd never computes.  Every product is in the step's type."""
    elt = 2 if dtype == "bfloat16" else 4
    step = _step(A, levels, B, W, dtype, detailed_metrics=False)
    most = roofline.Counts.most(step)
    roll = roofline.rollout_work(step, most.rollout_rows,
                                 most.rollout_cells)
    tpu_roll = tpu_roofline.rollout_model(A, T, levels, B, W, elt,
                                          rows_actor=False)
    assert set(roll.flops) == {dtype}
    assert roll.total_flops == tpu_roll["flops"] == (
        2 * B * levels * fused_turn.operations(A, 2 * W))

    learner = roofline.learner_work(step) + roofline.backward_work(step)
    assert set(learner.flops) == {dtype}
    tpu_learner = (tpu_roofline.train_model(A, T, levels, B, W, elt,
                                            rows_actor=False)["flops"]
                   - tpu_roll["flops"])
    n, din = step.samples, 2 * A * A
    assert learner.total_flops + 2 * (2 * n * din * W) == tpu_learner


@pytest.mark.parametrize("depth,width,detailed", [(1, 8, True),
                                                  (2, 16, False),
                                                  (3, 8, True)])
def test_learner_products_are_torchs_count(depth, width, detailed):
    """The learner phase's and the backward's products equal
    FlopCounterMode's count of ``learn_loss`` and of the parameters'
    gradients on the CPU; the rollout's equal its count of the generic
    turn's forward."""
    tree = tree_lib.generate_tree(
        TreeConfig(max_actions=3, max_transitions=T,
                   transition_threshold=0.3, depth_bound=3),
        seed=0, device="cpu")
    packed = stepping.make_packed_tables(tree)
    cfg = RNaDConfig(batch_size=16, detailed_metrics=detailed,
                     rollout_rows_actor="off")
    net_cfg = NetConfig(max_actions=3, width=width, depth=depth)
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(0))
    state = rnad.init_train_state(net, torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as roll:
        traj = rnad.rollout(state, tree, packed, cfg)
    inputs = rnad.learner_inputs(state, packed, traj)
    with FlopCounterMode(display=False) as fwd:
        loss, _ = rnad.learn_loss(state, packed, traj, 1.0, cfg,
                                  inputs=inputs)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(loss, list(state.net.parameters()))
    step = roofline.MLPStep.of(cfg, net_cfg, 3, T, tree.max_depth)
    assert roofline.learner_work(step).total_flops == fwd.get_total_flops()
    assert roofline.backward_work(step).total_flops == bwd.get_total_flops()
    assert roofline.rollout_work(step, 1, 1).total_flops == \
        roll.get_total_flops()


def test_bytes_are_hand_counts():
    """A = 2 (din 8), T = 2, one turn, B = 3, width 4 (H = 8); 2 distinct
    rows, 3 distinct cells, 2 learner rows; 87 parameters: fc0 8 x 4 + 4
    a tower, the policy fc1 4 x 2 + 2, the value fc1 4 + 1."""
    step = _step(2, 1, 3, 4, detailed_metrics=False)
    assert roofline.mlp_params(2, 4) == 36 + 10 + 36 + 5
    # lane ids 3, rows 2 x (16 + 4), cells 3 x 4, biases 8 + 3, noise
    # 3 x 4 + 3 x 2, outputs 3 + 12 + 6 + 3 + 6 floats; weights 8 x 8 + 8 x 3
    assert roofline.rollout_work(step, 2, 3).bytes == 4 * 114 + 4 * 88
    assert fused_turn.io_bytes(3, 2, 2, 8, 2, 3) == 808
    # a depth-2 MLP adds its two hidden layers' weights and biases once
    deep = _step(2, 1, 3, 4, depth=2, detailed_metrics=False)
    assert roofline.rollout_work(deep, 2, 3).bytes == 808 + 2 * (16 + 4) * 4
    # 6 half-steps: ids 3, rows 2 x 20 read; 6 x (8 + 2) written
    assert roofline.regather_work(step, 2).bytes == 4 * (3 + 40 + 60)
    # the sample: 6 half-steps x (2 + 4) floats read and written
    assert roofline.collate_work(step).bytes == 2 * 6 * 6 * 4
    # stored observations: K1 writes 3 lanes x 2 seats x 8 floats more, the
    # sample carries 8 more floats a half-step, and there is no regather
    stored = _step(2, 1, 3, 4, detailed_metrics=False, store_obs=True)
    assert roofline.rollout_work(stored, 2, 3).bytes == 808 + 4 * 48
    assert fused_turn.io_bytes(3, 2, 2, 8, 2, 3, store_obs=True) == 1000
    assert roofline.collate_work(stored).bytes == 2 * 6 * 14 * 4
    counts = roofline.Counts(2, 3, 2)
    assert [n for n, _ in roofline.step_phases(step, counts)] == [
        "rollout", "regather", *[n for n, _ in roofline.step_phases(
            stored, counts)][1:]]
    # obs and masks 6 x 10, four passes of 6 x 19, v-trace 24 x 6 x 2
    assert roofline.learner_work(step).bytes == 4 * (60 + 4 * 114 + 288)
    detailed = _step(2, 1, 3, 4)
    assert roofline.learner_work(detailed).bytes == 4 * (60 + 5 * 114 + 288)
    # two passes of 6 x 19, the gradients
    assert roofline.backward_work(step).bytes == 4 * (2 * 114 + 87)
    bf16 = _step(2, 1, 3, 4, "bfloat16", detailed_metrics=False)
    assert roofline.backward_work(bf16).bytes == 2 * 2 * 114 + 4 * 87
    # parameters, gradients, both moments and the target read; four written
    assert roofline.update_work(step).bytes == 4 * 9 * 87
    assert roofline.update_work(step).flops == {}


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_io_bytes_is_k1_bound_ofs_former_count(wdtype):
    """``chip_smoke.py::k1_bound_of`` counted K1's bytes itself until the
    count moved to ``fused_turn.io_bytes``; the value is the same."""
    import chip_smoke

    A, B, S, H = 3, 257, 40, 64
    gen = torch.Generator().manual_seed(0)
    din = 2 * A * A
    table = torch.rand((S, 128), generator=gen)
    w0 = torch.rand((din, H), generator=gen).to(wdtype)
    w1 = torch.rand((H, A + 1), generator=gen).to(wdtype)
    b0, b1 = torch.zeros(H), torch.zeros(A + 1)
    idx = torch.randint(0, S, (B,), generator=gen, dtype=torch.int32)
    actions = torch.randint(0, A, (2, B), generator=gen, dtype=torch.int32)
    args = (table, w0, b0, w1, b1, idx, torch.zeros(2 * B, A),
            torch.zeros(B, T))
    rows = int(torch.unique(idx).numel())
    cells = int(torch.unique(idx.long() * A * A + actions[0].long() * A
                             + actions[1].long()).numel())
    former = (4.0 * (B + rows * (2 * din + 2 * A) + cells * (T + 2)
                     + H + A + 1 + 2 * B * A + B * T
                     + B + 2 * B * A + 2 * B + B + 2 * B)
              + w0.element_size() * (w0.numel() + w1.numel()))
    ms, by, flops, nbytes = chip_smoke.k1_bound_of(fused_turn, args,
                                                   actions, A, T)
    assert nbytes == former == fused_turn.io_bytes(
        B, A, T, H, rows, cells, w0.element_size())
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOPS,
            chip_smoke.BF16_FLOPS) == (3.35e12, 67e12, 989e12)


def test_annotate_takes_the_larger_side_and_raises_past_the_bound():
    peaks = roofline.H100_SXM
    ops = roofline.Work({"float32": 67e9, "bfloat16": 989e9}, 3.35e9)
    # 1 ms on each product type, 1 ms of bytes: the products bind
    out = roofline.annotate(ops, 4.0, peaks)
    assert out["bound"] == "ops"
    assert out["bound_ms"] == pytest.approx(2.0)
    assert out["pct_of_roof"] == pytest.approx(50.0)
    assert out["pct_of_hbm"] == pytest.approx(25.0)
    assert out["pct_of_sum"] == pytest.approx(75.0)
    hbm = roofline.Work({"float32": 67e9}, 2 * 3.35e9)
    out = roofline.annotate(hbm, 2.0, peaks)
    assert (out["bound"], out["pct_of_roof"]) == ("hbm", pytest.approx(100))
    with pytest.raises(ValueError, match="miscounted"):
        roofline.annotate(hbm, 1.99, peaks)
    with pytest.raises(ValueError, match="not positive"):
        roofline.annotate(hbm, 0.0, peaks)
    assert peaks.flops("tf32") == 495e12


def test_counts_of_a_trajectory():
    """Distinct turn states, played (state, joint action) cells and the
    learner batch's turn states; the half-steps of a turn share a state."""
    idx = torch.tensor([[1, 1, 2], [1, 1, 2], [3, 4, 3], [3, 4, 3]],
                       dtype=torch.int32)
    actions = torch.tensor([[0, 1, 0], [2, 2, 2], [0, 0, 0], [1, 1, 1]],
                           dtype=torch.int32)
    traj = engine.Trajectory(indices=idx, policy=torch.zeros(4, 3, 3),
                             actions=actions, rewards=torch.zeros(4, 3),
                             values=torch.zeros(4, 3))
    other = engine.Trajectory(indices=idx[:, :1], policy=torch.zeros(4, 1, 3),
                              actions=actions[:, :1],
                              rewards=torch.zeros(4, 1),
                              values=torch.zeros(4, 1))
    # cells: (1, 0, 2), (1, 1, 2), (2, 0, 2), (3, 0, 1), (4, 0, 1)
    assert roofline.Counts.of(traj) == roofline.Counts(4, 5, 4)
    assert roofline.Counts.of(traj, other).learner_rows == 2


def _run(tmp_path, cfg, net_cfg):
    tree = tree_lib.generate_tree(
        TreeConfig(max_actions=3, max_transitions=T,
                   transition_threshold=0.3, depth_bound=3,
                   depth_bound_rule=ShapingRule(-1)), seed=0, device="cpu")
    run = rnad.RNaD(tree, cfg, net_cfg, directory_name="r",
                    runs_root=str(tmp_path), device="cpu")
    run.initialize()
    return run


@pytest.mark.parametrize("store_obs", [True, False])
@pytest.mark.parametrize("buffered", [False, True])
def test_profile_step_roofline_rows(tmp_path, buffered, store_obs):
    """``profile_step.py``'s phases on the CPU: the counts of the step's
    trajectories, and each phase beside the roofline phase of its place
    (a regather phase only where the rollout stores no observations)."""
    cfg = RNaDConfig(batch_size=64, n_batches_per_buffer=2 if buffered
                     else 1, buffer_mod=2 if buffered else 1,
                     store_rollout_obs=store_obs)
    run = _run(tmp_path, cfg, NetConfig(max_actions=3, width=16))
    buffer = buffer_lib.TrajectoryBuffer(2) if buffered else None
    phases, box = profile_step._phases(run, 1.0, buffer)
    for _, fn in phases:
        fn()
    counts = roofline.Counts.of(box["rollout"], box["traj"])
    assert 0 < counts.rollout_rows <= counts.rollout_cells
    measured = {name: 1e3 for name, _ in phases}  # far above any bound
    rows, work = profile_step.roofline_rows(run, measured, counts)
    assert list(rows) == [name for name, _ in phases]
    assert any(n.startswith("regather") for n in rows) == (not store_obs)
    assert all(0 < r["pct_of_roof"] <= 100 for r in rows.values())
    step = roofline.MLPStep.of(cfg, run.net_config, 3, T,
                               run.tree.max_depth)
    assert step.buffered == buffered
    whole = roofline.total(roofline.step_phases(step, counts))
    assert work == whole
    roll = roofline.rollout_work(step, counts.rollout_rows,
                                 counts.rollout_cells)
    first = rows[phases[0][0]]["bound_ms"]
    assert first == pytest.approx(1e3 * roll.bound_s() / cfg.buffer_mod)


def test_only_the_mlp_has_a_model():
    with pytest.raises(ValueError, match="MLP towers only"):
        roofline.MLPStep.of(RNaDConfig(), NetConfig(type="ConvNet",
                                                    max_actions=3), 3, T, 3)
    lifted = copy.deepcopy(profile_step.CONFIGS["convnet"][2])
    with pytest.raises(ValueError, match="lifted"):
        roofline.MLPStep.of(lifted, NetConfig(max_actions=3), 3, T, 3)


@pytest.mark.parametrize("net", ["mlp", "offpol"])
def test_cli_prints_the_counts(net, capsys):
    roofline.main(["--net", net, "--batch-size", "64"])
    out = capsys.readouterr().out
    assert "not a measurement" in out
    # a line a phase and one for the step; the configs store the rollout's
    # observations (store_rollout_obs), so no regather phase
    assert out.count(": bound ") == (6 if net == "offpol" else 5)
    assert "regather" not in out
    assert "B=64" in out
