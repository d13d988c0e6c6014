"""The work models: the MLP's counts equal the program's roofline
(``rnad_tpu_torch/roofline.py``) on ``profile_step.py``'s shapes today, the
frozen kernel counts equal the program's, the EquiNet's count equals
a count of the products one exchangeable layer runs at a tiny size, and
the ConvNet's equals a count of the products the plain ConvNet runs."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.work import convnet, equinet, kernels, mlp


def _config(name):
    from rnad_tpu_torch import profile_step

    tree, net, cfg = profile_step.CONFIGS[name]
    rnad = cfg.to_json()
    return ({"tree": {"max_actions": tree.max_actions,
                      "max_transitions": tree.max_transitions},
             "net": net.to_json(), "rnad": rnad}, cfg, net, tree)


@pytest.mark.parametrize("name", ["mlp", "offpol"])
def test_mlp_counts_equal_roofline(name):
    from rnad_tpu_torch import roofline

    config, cfg, net, tree = _config(name)
    if name == "offpol":  # the on-policy step of offpol's shapes
        cfg = dataclasses.replace(cfg, n_batches_per_buffer=1, buffer_mod=1)
    levels, rows, cells = tree.depth_bound, 1234.0, 5678.0
    step = roofline.MLPStep.of(cfg, net, tree.max_actions,
                               tree.max_transitions, levels)
    theirs = roofline.step_phases(step, roofline.Counts(rows, cells, rows))
    ours = mlp.phases(config, cfg.batch_size, levels, rows, cells)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.flops == b.flops and a.bytes == b.bytes
    total = roofline.total(theirs)
    assert mlp.step(config, cfg.batch_size, levels, rows, cells).ops_s() \
        == pytest.approx(total.ops_s(), rel=1e-12)


def test_kernel_counts_equal_program():
    from rnad_tpu_torch.ops import fused_turn, rmplus

    for A, H in ((3, 512), (5, 512)):
        assert kernels.fused_turn_operations(A, H) == fused_turn.operations(
            A, H)
        for store in (False, True):
            assert kernels.fused_turn_io_bytes(
                32768, A, 2, H, 300, 2000, 4, store) == fused_turn.io_bytes(
                32768, A, 2, H, 300, 2000, 4, store)
    assert kernels.rmplus_operations(5, 5, 128) == rmplus.operations(5, 5,
                                                                     128)
    assert kernels.rmplus_io_bytes(5, 5, 1000) == rmplus.io_bytes(5, 5, 1000)


def test_exchangeable_layer_count():
    from rnad_tpu_torch.models import nets

    n, A, cin, C = 3, 4, 5, 7
    layer = nets._ExchangeableDense(cin, C)
    with FlopCounterMode(display=False) as counter:
        layer(torch.randn(n, A, A, cin))
    # six block products: cells n A^2, four pools n A, the mean n rows
    assert equinet.layer_flops(n, A, cin, C) == 2 * n * (A * A + 4 * A + 1) \
        * cin * C == counter.get_total_flops()


def test_equinet_forward_count():
    from rnad_tpu_torch.config import NetConfig
    from rnad_tpu_torch.models import nets

    A, C, depth, n = 5, 8, 2, 6
    net = nets.build_net(NetConfig(type="EquiNet", max_actions=A, channels=C,
                                   depth=depth, solver_iters=4,
                                   solver_prime=True))
    obs = torch.randn(n, 2, A, A)
    feats = nets.equinet_solver_features(net, obs)
    with FlopCounterMode(display=False) as counter:
        net(obs, feats)
    assert equinet.forward_flops(n, A, C, depth, 8) == \
        counter.get_total_flops()


def test_flagship_step_count():
    config = {"tree": {"max_actions": 5},
              "net": {"channels": 64, "depth": 2, "solver_iters": 128,
                      "compute_dtype": "bfloat16"}}
    work = equinet.step(config, 32768, 6)
    assert set(work.flops) == {"bfloat16"}
    assert work.total_flops == pytest.approx(1.1507e12, rel=1e-4)


def test_convnet_counts_needed_products():
    """The plain ConvNet's forward and backward products at a small shape,
    counted by torch: each CrossConv's gathered taps are the A row and A
    column cells an output needs, never the zero padding."""
    from benchmark.reference import nets
    from benchmark.reference.families import convnet as family

    n, A, C, depth, c0 = 6, 3, 4, 2, 9
    net = {"type": "ConvNet", "channels": C, "depth": depth,
           "batch_norm": True}
    gen = torch.Generator().manual_seed(0)
    params = {name: (torch.rand(shape, generator=gen) - 0.5)
              .requires_grad_(True)
              for name, shape, _ in nets.param_shapes(net, A, c0)}
    state = {name: torch.rand(shape, generator=gen) + 0.5
             for name, shape, _ in nets.state_shapes(net, A, c0)}
    obs = torch.randn(n, c0, A, A, generator=gen)
    with FlopCounterMode(display=False) as counter:
        logits, values = family.forward(
            params, obs, net, nets.Precision("float32"), state=state,
            train=True, mask=torch.tensor([1.0, 0, 1, 1, 0, 1]))
    assert counter.get_total_flops() == convnet.forward_flops(
        n, A, C, depth, c0) == 2 * n * A * A * (
            2 * A * (c0 * C + 2 * depth * C * C) + C * (A + 1))
    with FlopCounterMode(display=False) as counter:
        (logits.sum() + values.sum()).backward()
    assert counter.get_total_flops() == convnet.backward_flops(
        n, A, C, depth, c0)


def test_convnet_step_count():
    config = {"tree": {"max_actions": 3},
              "net": {"channels": 16, "depth": 2,
                      "compute_dtype": "float32"},
              "rnad": {"frozen_net_dtype": "float32",
                       "obs_transform": {"kind": "lift", "channels": 8}}}
    lanes, levels = 1024, 4
    n = 2 * levels * lanes
    work = convnet.step(config, lanes, levels)
    forward = convnet.forward_flops(n, 3, 16, 2, 9)
    assert set(work.flops) == {"float32"}
    # the rollout's levels turns of 2 lanes observations are n in all
    assert work.total_flops == pytest.approx(
        5 * forward + convnet.backward_flops(n, 3, 16, 2, 9), rel=1e-12)
