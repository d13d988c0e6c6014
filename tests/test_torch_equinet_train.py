"""The trainable EquiNet's pass on kernels K4 and K5 (``ops/equinet.py``'s
``forward_train``) on the CPU: K5's plain twin, ``equinet_backward_plain``,
against ``torch.autograd.grad`` of ``EquiNet.forward`` (in float32 within
round-off, and bit for bit in bfloat16, whose rounding points it follows);
the autograd function routing every leaf's gradient (with the plain
versions in the kernels' places); the learner's gate, which keeps every
other net's eager pass and opens no fused span; and K5's operation count.
The kernels themselves are held to the eager pass on the card
(tests/test_torch_cuda.py)."""

import json

import pytest
import torch

from benchmark.work import equinet as work_equinet
from rnad_tpu_torch.config import NetConfig, RNaDConfig, TreeConfig
from rnad_tpu_torch.env import tree as tree_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import equinet as equinet_ops
from rnad_tpu_torch.ops import stepping
from rnad_tpu_torch.parallel import tensor_parallel
from rnad_tpu_torch.parallel.mesh import ModelGroup
from rnad_tpu_torch.utils import timing

N = 41  # not a multiple of any tile


def _net(A=3, C=16, depth=2, primed=True, dtype="float32", seed=0,
         kind="EquiNet"):
    cfg = NetConfig(type=kind, max_actions=A, channels=C, depth=depth,
                    solver_iters=8 if primed else 0, solver_prime=primed,
                    compute_dtype=dtype, width=16)
    net = nets.build_net(cfg, torch.Generator().manual_seed(seed))
    if kind == "EquiNet":  # heads off zero, so the tower has a gradient
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            for head in (net.policy, net.value):
                head.weight.normal_(0.0, 0.3, generator=g)
                head.bias.normal_(0.0, 0.1, generator=g)
    return net


def _tied_obs(A, n=N, seed=1):
    """Observations with illegal actions, a third of them with every cell
    of a row equal, another third with every cell of a column equal: the
    max pools of the input (and of the layers above, through them) tie."""
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(n, 2, A, A, generator=g)
    legal_r = torch.rand(n, A, generator=g) < 0.8
    legal_c = torch.rand(n, A, generator=g) < 0.8
    legal_r[:, 0] = legal_c[:, 0] = True
    third = n // 3
    obs[:third, 0] = obs[:third, 0, :, :1]
    obs[third:2 * third, 0] = obs[third:2 * third, 0, :1, :]
    legal = (legal_r[:, :, None] & legal_c[:, None, :]).float()
    obs[:, 0] *= legal
    obs[:, 1] = legal
    return obs


def _feats(net, obs):
    return (nets.equinet_solver_features(net, obs) if net.solver_iters
            else None)


def _grads_out(A, n=N, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, A, generator=g), torch.randn(n, generator=g)


def _autograd(net, obs, feats, dlogits, dvalue):
    out = net(obs, feats)
    return torch.autograd.grad(out, equinet_ops.leaves(net),
                               (dlogits, dvalue))


def _ties(net, obs, feats, dtype):
    """Max-pool ties in the input and in each hidden layer's output."""
    x = obs.permute(0, 2, 3, 1)
    if net.solver_iters:
        x = torch.cat([x, feats[0]], dim=-1)
    h, count = x.to(dtype), 0
    for i in range(net.depth):
        for dim in (1, 2):
            count += int(((h == h.amax(dim, keepdim=True)).sum(dim) > 1)
                         .sum())
        h = torch.relu(getattr(net, f"ex{i}")(h, dtype))
    return count


@pytest.mark.parametrize("primed", [True, False],
                         ids=["primed", "unprimed"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("A", [3, 5])
def test_plain_backward_is_autograd_in_float32(A, C, depth, primed):
    """K5's twin in float32 (every rounding the identity) gives each leaf
    the gradient autograd gives through ``EquiNet.forward``, within
    float32 round-off of the leaf's scale, for nonzero gradients of both
    outputs and inputs whose max pools tie."""
    net = _net(A, C, depth, primed)
    obs = _tied_obs(A)
    feats = _feats(net, obs)
    dlogits, dvalue = _grads_out(A)
    assert _ties(net, obs, feats, torch.float32) > 0
    want = _autograd(net, obs, feats, dlogits, dvalue)
    got = equinet_ops.equinet_backward_plain(net, obs, feats, dlogits,
                                             dvalue)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float(w.abs().max()) > 0
        assert float((g - w).abs().max()) <= 2e-6 * float(w.abs().max())


BF16_SHAPES = [dict(A=5, C=64, depth=2, primed=True),
               dict(A=3, C=16, depth=1, primed=False),
               dict(A=4, C=32, depth=3, primed=True),
               dict(A=3, C=48, depth=2, primed=False)]


@pytest.mark.parametrize("shape", BF16_SHAPES,
                         ids=lambda s: "A{A}C{C}d{depth}".format(**s))
def test_plain_backward_follows_bf16_autograd_bitwise(shape):
    """In bfloat16 the twin rounds where autograd's graph rounds (the
    incoming gradients, each product, pooled sum and broadcast, each add
    of an input gradient in the engine's order, each leaf once), so on
    the CPU its gradients are autograd's bit for bit but where the CPU's
    bf16 product sums a weight gradient's float32 terms in another order
    than the float32 product (at 48 channels): there an element may part
    by one bf16 unit in the last place, on at most 1 % of a leaf."""
    net = _net(dtype="bfloat16", **shape)
    obs = _tied_obs(shape["A"])
    feats = _feats(net, obs)
    dlogits, dvalue = _grads_out(shape["A"])
    want = _autograd(net, obs, feats, dlogits, dvalue)
    got = equinet_ops.equinet_backward_plain(net, obs, feats, dlogits,
                                             dvalue)
    for g, w in zip(got, want):
        parted = g != w
        assert float(parted.float().mean()) <= 0.01
        ulp = w.abs().to(torch.bfloat16).float() * 2.0 ** -7
        assert bool(((g - w).abs() <= ulp)[parted].all())


def _plain_kernels(monkeypatch):
    """The kernels' places taken by their plain versions, the gate open:
    what the card runs, on the CPU."""
    launches = {"k4": 0, "k5": 0}

    def k4(nets_, obs, feats, dtype, values=None, params=None):
        launches["k4"] += 1
        return equinet_ops.equinet_frozen_plain(nets_, obs, feats, dtype,
                                                values)

    def k5(net, obs, feats, params, dlogits, dvalue):
        launches["k5"] += 1
        assert torch.equal(params, equinet_ops.pack([net]))
        return equinet_ops.equinet_backward_plain(net, obs, feats, dlogits,
                                                  dvalue)

    monkeypatch.setattr(equinet_ops, "unsupported", lambda *a: None)
    monkeypatch.setattr(equinet_ops, "equinet_frozen", k4)
    monkeypatch.setattr(equinet_ops, "equinet_backward", k5)
    return launches


@pytest.mark.parametrize("primed", [True, False],
                         ids=["primed", "unprimed"])
def test_forward_train_routes_every_leaf(monkeypatch, tmp_path, primed):
    """``forward_train`` returns the net's own outputs and gives each of
    its parameters its gradient (here the plain versions in the kernels'
    places: bit for bit the eager pass), with one forward and one backward
    launch inside ``rnad.learn.forward.fused`` and
    ``rnad.learn.backward.fused``."""
    net = _net(A=5, C=64, primed=primed, dtype="bfloat16")
    obs = _tied_obs(5)
    feats = _feats(net, obs)
    dlogits, dvalue = _grads_out(5)
    want_out = net(obs, feats)
    want = torch.autograd.grad(want_out, list(net.parameters()),
                               (dlogits, dvalue))
    launches = _plain_kernels(monkeypatch)
    with timing.trace(str(tmp_path)):
        out = equinet_ops.forward_train(net, obs, feats)
        got = torch.autograd.grad(out, list(net.parameters()),
                                  (dlogits, dvalue))
    assert launches == {"k4": 1, "k5": 1}
    for g, w in zip(out + got, want_out + want):
        assert torch.equal(g, w)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["rnad.learn.backward.fused",
                             "rnad.learn.forward.fused"]


def _tree():
    cfg = TreeConfig(max_actions=3, max_transitions=2,
                     transition_threshold=0.3, depth_bound=3)
    return tree_lib.generate_tree(cfg, seed=0, device="cpu")


def _learner_step(net, tree):
    """One rollout and one learner update of ``net`` on ``tree``: the
    loss, the gradient norm and the weights after the update."""
    packed = stepping.make_packed_tables(tree)
    cfg = RNaDConfig(batch_size=32, eta=0.5, lr=5e-3, logit_clip=2.0)
    state = rnad.init_train_state(net, torch.Generator().manual_seed(2))
    traj = rnad.rollout(state, tree, packed, cfg)
    metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
    return ([metrics["loss"], metrics["gradient_norm"]]
            + [p.detach().clone() for p in state.net.parameters()])


def test_learner_step_on_the_function_is_the_eager_step(monkeypatch):
    """A bf16 EquiNet's learner step through ``forward_train`` (the gate
    open, the plain versions in the kernels' places) gives the eager
    step's loss, gradient norm and updated weights bit for bit."""
    tree = _tree()
    want = _learner_step(_net(dtype="bfloat16"), tree)
    launches = _plain_kernels(monkeypatch)
    got = _learner_step(_net(dtype="bfloat16"), tree)
    assert launches["k5"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the nets whose learner pass stays eager, and what the gate names
EAGER = {
    "mlp": (lambda: _net(kind="MLP"), "not plain EquiNets"),
    "convnet": (lambda: _net(kind="ConvNet", C=8, depth=1,
                             dtype="bfloat16"), "not plain EquiNets"),
    "float32": (lambda: _net(), "dtype"),
    "tensor_parallel": (lambda: tensor_parallel.shard_module(
        _net(dtype="bfloat16"), ModelGroup(rank=0, world=1)),
        "not plain EquiNets"),
    "bfloat16_on_the_cpu": (lambda: _net(dtype="bfloat16"),
                            "observations on cpu"),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_learner_gate_keeps_the_eager_pass(name, monkeypatch, tmp_path):
    """The MLP, the ConvNet, a float32 EquiNet, the tensor-parallel
    EquiNet and a bf16 EquiNet on the CPU keep the eager learner pass:
    the gate names why, ``forward_train`` is never called, and a traced
    learner loss opens no fused span of the learner's forward (nor so,
    without the function, of its backward)."""
    make, why = EAGER[name]
    net = make()
    tree = _tree()
    obs = _tied_obs(3)
    feats = equinet_ops.solver_features(net, obs)
    assert not equinet_ops.trains(net, obs, feats)
    assert why in equinet_ops.unsupported([net], obs, feats,
                                          getattr(net, "dtype", None))

    def refuse(*a, **k):
        raise AssertionError("forward_train called")

    monkeypatch.setattr(equinet_ops, "forward_train", refuse)
    packed = stepping.make_packed_tables(tree)
    cfg = RNaDConfig(batch_size=32, eta=0.5, logit_clip=2.0)
    state = rnad.init_train_state(net, torch.Generator().manual_seed(2))
    traj = rnad.rollout(state, tree, packed, cfg)
    with timing.trace(str(tmp_path)):
        loss, _ = rnad.learn_loss(state, packed, traj, 0.5, cfg)
    assert loss.requires_grad
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "rnad.learn.forward" in names
    assert "rnad.learn.forward.fused" not in names


@pytest.mark.parametrize("C,depth,why", [
    (64, 2, None), (16, 5, None), (32, 3, None), (48, 2, None),
    (64, 3, "depth 3 at C = 64"), (32, 4, "depth 4 at C = 32"),
    (80, 1, "C = 80"), (128, 4, "C = 128")])
def test_backward_unsupported_names_the_shapes(C, depth, why):
    net = _net(A=5, C=C, depth=depth, dtype="bfloat16")
    named = equinet_ops.backward_unsupported(net)
    assert (named is None) if why is None else why in named
    if C <= equinet_ops.MAX_TRAIN_CHANNELS:
        assert (equinet_ops.backward_slices(C, depth)
                <= equinet_ops.MAX_TRAIN_SLICES) == (why is None)


@pytest.mark.parametrize("n,A,C,depth,c0", [(393216, 5, 64, 2, 8),
                                            (100, 3, 16, 1, 2),
                                            (7, 4, 32, 3, 8)])
def test_backward_operations_are_the_benchmarks_work(n, A, C, depth, c0):
    """K5's operations: the recomputed forward and the benchmark's count of
    the backward (``benchmark/work/equinet.py``)."""
    assert equinet_ops.backward_operations(n, A, C, depth, c0) == (
        work_equinet.forward_flops(n, A, C, depth, c0)
        + work_equinet.backward_flops(n, A, C, depth, c0))
