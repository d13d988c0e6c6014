"""The plain ConvNet family and the lift against the port's on the CPU, at
r5-noisy-conv's shape (A = 3, 16 channels, depth 2, the lift's 8 + 1
input channels), on seeded weights and drawn running averages; and the
weights the existing configurations draw, held to the flat draw over
their trained leaves alone."""

import math

import pytest
import torch

from benchmark import cells, system, trees
from benchmark.reference import nets as ref_nets
from benchmark.reference import rnad as ref
from benchmark.reference.families import convnet as family

A, C, DEPTH, CIN = 3, 16, 2, 9
NET = {"type": "ConvNet", "channels": C, "depth": DEPTH, "batch_norm": True,
       "compute_dtype": "float32"}


def _nets(seed=3):
    """The port's ConvNet and the plain family's weights and state, the
    same: the BatchNorm scales and biases drawn too, so that both are
    read."""
    from rnad_tpu_torch.models import nets

    gen = torch.Generator().manual_seed(seed)
    weights = system.make_weights(NET, A, gen, CIN)
    for name in list(weights):
        if ".bn" in name and name.endswith(("scale", "bias")):
            weights[name] = 1.0 + 0.5 * torch.randn(C, generator=gen)
    net = nets.ConvNet(A, channels=C, depth=DEPTH, batch_norm=True,
                       in_channels=CIN)
    net.load_state_dict(weights, strict=True)
    kept = {n for n, _, _ in ref_nets.state_shapes(NET, A, CIN)}
    params = {k: v for k, v in weights.items() if k not in kept}
    state = {k: v.clone() for k, v in weights.items() if k in kept}
    obs = torch.randn(24, CIN, A, A, generator=gen)
    return net, params, state, obs


def _close(got, want):
    scale = want.abs().amax()
    assert float((got - want).abs().amax()) <= 1e-5 * float(scale), (
        float((got - want).abs().amax()), float(scale))


def test_eval_forward_agrees():
    net, params, state, obs = _nets()
    with torch.no_grad():
        logits, values = net(obs)
        want = family.forward(params, obs, NET,
                              ref_nets.Precision("float32"), state=state)
    _close(logits, want[0])
    _close(values, want[1])


def test_train_forward_and_running_averages_agree():
    from rnad_tpu_torch.models import nets

    net, params, state, obs = _nets(4)
    mask = (torch.arange(obs.shape[0]) % 2).float()  # half the samples
    before = {k: v.clone() for k, v in state.items()}
    with torch.no_grad():
        logits, values = nets.forward_train(net, obs, mask)
        want = family.forward(params, obs, NET,
                              ref_nets.Precision("float32"), state=state,
                              train=True, mask=mask)
    _close(logits, want[0])
    _close(values, want[1])
    buffers = dict(net.named_buffers())
    assert set(buffers) == set(state)
    for k, v in state.items():
        assert not torch.equal(v, before[k])
        _close(buffers[k] - before[k], v - before[k])


def test_lift_agrees():
    from rnad_tpu_torch.ops.obs_transform import ObsTransform

    config = cells.find("mlp256-demo.train-b262k").config
    arrays, _, _ = trees.make_tree(config["tree"])
    gen = torch.Generator().manual_seed(5)
    lift = system.make_lift(
        {"rnad": {"obs_transform": {"kind": "lift", "channels": CIN - 1,
                                    "bias_scale": 1.0}}}, A, gen)
    raw_game = ref.Game(arrays, "cpu")
    game = ref.Game(arrays, "cpu", lift, 0.15)
    idx = torch.randint(1, raw_game.ev.shape[0], (32,), generator=gen)
    eps = torch.randn(64, CIN - 1, A, A, generator=gen)
    raw, masks = raw_game.observe(idx)
    lifted, lifted_masks = game.observe(idx, eps)
    port = ObsTransform(mix=lift["mix"], bias=lift["bias"], sigma=0.15)
    assert lifted.shape == (64, CIN, A, A)
    assert torch.equal(lifted, port.apply(raw, eps))
    assert torch.equal(lifted_masks, masks)


@pytest.mark.parametrize("name", ["mlp256-demo.train-b262k",
                                  "flagship3.train-b65k"])
def test_weights_are_the_flat_draw(name):
    config = cells.find(name).config
    net, A_ = config["net"], config["tree"]["max_actions"]
    assert ref_nets.in_channels(config) == 2
    assert ref_nets.state_shapes(net, A_) == []
    shapes = ref_nets.param_shapes(net, A_)
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator().manual_seed(2**40 + 9)
    flat = torch.rand((sum(sizes),), generator=gen) * 2 - 1
    gen.manual_seed(2**40 + 9)
    got = system.make_weights(net, A_, gen, ref_nets.in_channels(config))
    assert list(got) == [n for n, _, _ in shapes]
    for (leaf, shape, bound), part in zip(shapes, flat.split(sizes)):
        want = (part.reshape(shape) * bound if bound is not None
                else torch.ones(shape))
        assert torch.equal(got[leaf], want), leaf
    assert system.make_lift(config, A_, gen) is None
