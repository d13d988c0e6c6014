"""rnad_tpu_torch.ops.equinet (kernel K4, the EquiNet's frozen passes) on
the CPU: its plain version is the nets' own forwards, the learner's frozen
passes take it only for what the kernel takes (and keep every other net's
eager passes, tensor for tensor), and its operation count is the
benchmark's.  The kernel itself is held to the eager passes on the card
(tests/test_torch_cuda.py).  Every comparison here is bitwise."""

import json

import pytest
import torch

from benchmark.work import equinet as work_equinet
from rnad_tpu_torch.config import NetConfig, RNaDConfig
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import equinet as equinet_ops
from rnad_tpu_torch.parallel import tensor_parallel
from rnad_tpu_torch.parallel.mesh import ModelGroup
from rnad_tpu_torch.utils import timing

N = 37  # not a multiple of any tile
CPU_ONLY = "observations on cpu (the kernel runs on CUDA)"


def _net(A=3, C=16, depth=2, solver_iters=8, prime=True, dtype="bfloat16",
         seed=0, kind="EquiNet"):
    cfg = NetConfig(type=kind, max_actions=A, channels=C, depth=depth,
                    solver_iters=solver_iters, solver_prime=prime,
                    compute_dtype=dtype, width=16)
    net = nets.build_net(cfg, torch.Generator().manual_seed(seed))
    if kind == "EquiNet" and net.primed:  # move the zero heads off zero
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            for head in (net.policy, net.value):
                head.weight.normal_(0.0, 0.1, generator=g)
                head.bias.normal_(0.0, 0.1, generator=g)
    return net


def _obs(A, n=N, seed=1, channels=2):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(n, channels, A, A, generator=g)
    legal_r = torch.rand(n, A, generator=g) < 0.8
    legal_c = torch.rand(n, A, generator=g) < 0.8
    legal_r[:, 0] = legal_c[:, 0] = True
    legal = (legal_r[:, :, None] & legal_c[:, None, :]).float()
    obs[:, 0] *= legal
    obs[:, 1] = legal
    return obs


def _state(net):
    state = rnad.init_train_state(net, torch.Generator())
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():  # three different frozen nets
        for frozen in (state.net_target, state.net_reg, state.net_reg_):
            for p in frozen.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    return state


def _feats(net, obs):
    if isinstance(net, nets.EquiNet) and net.solver_iters:
        return nets.equinet_solver_features(net, obs)
    return None


def _eager(state, obs, feats, dtype):
    """The frozen passes under "off" as the learner ran them before K4."""
    logits_t, values_t = state.net_target(obs, feats, dtype=dtype)
    logits_reg, _ = state.net_reg(obs, feats, dtype=dtype)
    logits_reg_, _ = state.net_reg_(obs, feats, dtype=dtype)
    return logits_t, values_t, logits_reg, logits_reg_


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


SHAPES = [dict(A=5, C=64, depth=2, solver_iters=8, prime=True),
          dict(A=3, C=16, depth=1, solver_iters=0, prime=False),
          dict(A=4, C=32, depth=3, solver_iters=8, prime=False),
          dict(A=2, C=128, depth=4, solver_iters=4, prime=True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_the_nets_own_forwards(shape, dtype):
    net = _net(**shape)
    state = _state(net)
    obs = _obs(shape["A"])
    feats = _feats(net, obs)
    frozen = (state.net_target, state.net_reg, state.net_reg_)
    plain = equinet_ops.equinet_frozen_plain(frozen, obs, feats, dtype)
    assert len(plain) == 3
    for (logits, values), f in zip(plain, frozen):
        assert logits.shape == (N, shape["A"]) and values.shape == (N,)
        _equal((logits, values), f(obs, feats, dtype=dtype))
    values = equinet_ops.equinet_frozen_plain(frozen, obs, feats, dtype,
                                              values=(True, False, True))
    assert values[1][1] is None
    _equal(values[0] + values[2], plain[0] + plain[2])
    _equal(values[1][:1], plain[1][:1])


def _tensor_parallel(net):
    return tensor_parallel.shard_module(net, ModelGroup(rank=0, world=1))


# (net, frozen dtype, what ``unsupported`` names)
EAGER = {
    "float32": (lambda: _net(dtype="float32"), "float32", "dtype"),
    "A9": (lambda: _net(A=9), "bfloat16", "A = 9"),
    "C72": (lambda: _net(C=72), "bfloat16", "C = 72"),
    "C8": (lambda: _net(C=8), "bfloat16", "C = 8"),
    "tensor_parallel": (lambda: _tensor_parallel(_net()), "bfloat16",
                        "not plain EquiNets"),
    "convnet": (lambda: _net(kind="ConvNet", C=8, depth=1), "bfloat16",
                "not plain EquiNets"),
    "mlp": (lambda: _net(kind="MLP"), "float32", "not plain EquiNets"),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_frozen_passes_keep_the_eager_path(name):
    """What the kernel does not take keeps the eager passes, tensor for
    tensor: ``unsupported`` names why before it names the CPU."""
    make, dtype_name, why = EAGER[name]
    net = make()
    A = net.max_actions
    state = _state(net)
    cfg = RNaDConfig(fuse_net_passes="off", frozen_net_dtype=dtype_name)
    dtype = rnad.frozen_dtype(state.net, cfg)
    obs = _obs(A)
    feats = _feats(net, obs)
    frozen = (state.net_target, state.net_reg, state.net_reg_)
    assert why in equinet_ops.unsupported(frozen, obs, feats, dtype)
    before = equinet_ops.equinet_frozen.launches
    with torch.no_grad():
        got = rnad._frozen_passes(state, cfg, "off", obs, feats)
        want = _eager(state, obs, feats, dtype)
    _equal(got, want)
    assert equinet_ops.equinet_frozen.launches == before


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_frozen_passes_on_the_cpu_are_eager(shape):
    """A bf16 EquiNet that the kernel takes still runs its eager passes on
    the CPU (the kernel is for the card)."""
    net = _net(**shape)
    state = _state(net)
    cfg = RNaDConfig(fuse_net_passes="off")
    obs = _obs(shape["A"])
    feats = _feats(net, obs)
    frozen = (state.net_target, state.net_reg, state.net_reg_)
    assert equinet_ops.unsupported(frozen, obs, feats,
                                   torch.bfloat16) == CPU_ONLY
    with torch.no_grad():
        got = rnad._frozen_passes(state, cfg, "off", obs, feats)
    _equal(got, _eager(state, obs, feats, torch.bfloat16))


def test_dispatch_routes_the_nets_and_opens_the_span(monkeypatch, tmp_path):
    """Where the kernel engages, the frozen passes read its outputs as the
    target's logits and values and the reg nets' logits, inside the span
    ``rnad.learn.frozen.fused`` (here on the CPU, with ``unsupported``
    naming nothing and the plain version in the kernel's place)."""
    net = _net(A=5, C=64)
    state = _state(net)
    cfg = RNaDConfig(fuse_net_passes="off")
    obs = _obs(5)
    feats = _feats(net, obs)
    calls = []
    monkeypatch.setattr(equinet_ops, "unsupported", lambda *a: None)
    monkeypatch.setattr(equinet_ops, "equinet_frozen", lambda *a, **k: (
        calls.append(k["values"])
        or equinet_ops.equinet_frozen_plain(*a, **k)))
    with timing.trace(str(tmp_path)), torch.no_grad():
        with timing.span("rnad.learn.frozen"):
            got = rnad._frozen_passes(state, cfg, "off", obs, feats)
    _equal(got, _eager(state, obs, feats, torch.bfloat16))
    assert calls == [(True, False, False)]  # only the target's values
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"}
    outer, inner = spans["rnad.learn.frozen"], spans["rnad.learn.frozen.fused"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]


def test_unsupported_names_the_inputs():
    net = _net(A=5, C=64)
    state = _state(net)
    frozen = (state.net_target, state.net_reg, state.net_reg_)
    obs = _obs(5)
    feats = _feats(net, obs)
    bf16 = torch.bfloat16
    # all the kernel takes but the device
    assert equinet_ops.unsupported(frozen, obs, feats, bf16) == CPU_ONLY
    assert equinet_ops.unsupported(frozen, obs.to(bf16), feats,
                                   bf16) == CPU_ONLY
    assert "solver features" in equinet_ops.unsupported(frozen, obs, None,
                                                        bf16)
    assert "solver features" in equinet_ops.unsupported(
        frozen, obs, (feats[0][:-1], feats[1], feats[2]), bf16)
    assert "solver features" in equinet_ops.unsupported(
        frozen, obs, (feats[0], feats[1].double(), feats[2]), bf16)
    assert "observations" in equinet_ops.unsupported(
        frozen, obs.double(), feats, bf16)
    assert "observations" in equinet_ops.unsupported(
        frozen, obs[:, :1], feats, bf16)
    other = _state(_net(A=5, C=32)).net_reg
    assert "different shapes" in equinet_ops.unsupported(
        (state.net_target, other), obs, feats, bf16)
    assert "0 nets" in equinet_ops.unsupported((), obs, feats, bf16)
    assert "5 nets" in equinet_ops.unsupported(frozen + frozen[:2], obs,
                                               feats, bf16)
    with pytest.raises(ValueError, match="a flag a net|one values flag"):
        equinet_ops.equinet_frozen(frozen, obs, feats, bf16,
                                   values=(True,))


@pytest.mark.parametrize("n,A,C,depth,c0", [(393216, 5, 64, 2, 8),
                                            (100, 3, 16, 1, 2),
                                            (7, 8, 128, 4, 8)])
def test_operations_are_the_benchmarks_frozen_work(n, A, C, depth, c0):
    """K4's operations are the benchmark's count of three forwards
    (``benchmark/work/equinet.py::forward_flops``, the frozen part of the
    learner's four passes)."""
    assert equinet_ops.operations(n, A, C, depth, c0) == (
        3 * work_equinet.forward_flops(n, A, C, depth, c0))
    assert equinet_ops.operations(n, A, C, depth, c0, nets=1) == (
        work_equinet.forward_flops(n, A, C, depth, c0))


def test_io_bytes_at_the_flagship_shape():
    n, A, C, depth = 393216, 5, 64, 2
    params = (6 * 8 * 64 + 64) + (6 * 64 * 64 + 64) + 2 * (64 + 8 + 1) + 2
    want = (4 * n * 2 * 25 + 4 * n * 25 * 6 + 4 * n * 6 + 4 * 3 * params
            + 4 * 3 * n * 6)
    assert equinet_ops.io_bytes(n, A, C, depth, 2, 8) == want
    plain = (6 * 2 * 64 + 64) + (6 * 64 * 64 + 64) + 2 * (64 + 2 + 1)
    assert equinet_ops.io_bytes(n, A, C, depth, 2, 2, primed=False) == (
        4 * n * 2 * 25 + 4 * 3 * plain + 4 * 3 * n * 6)


def test_leaves_are_the_modules_parameters():
    """Every parameter once, in the kernel's order: the layers, the
    heads, the gates."""
    for shape in SHAPES:
        net = _net(**shape)
        name = {id(p): k for k, p in net.named_parameters()}
        got = [name[id(p)] for p in equinet_ops.leaves(net)]
        want = [f"ex{i}.{leaf}" for i in range(shape["depth"])
                for leaf in ("kernel", "bias")]
        want += ["policy.weight", "policy.bias", "value.weight",
                 "value.bias"]
        if shape["prime"]:
            want += ["policy_prime_gate", "value_prime_gate"]
        assert got == want and sorted(got) == sorted(name.values())
        assert equinet_ops.input_channels(net) == 2 + (
            6 if shape["solver_iters"] else 0)


def test_probe_differences_count_bf16_ulps():
    """The probe's measure of a gap: the share of elements that differ and
    the largest gap in bf16 units in the last place of the eager output
    (or of the head's own output where a gate's term came after it)."""
    from rnad_tpu_torch import equinet_probe

    want = torch.tensor([1.0, 1.5, -3.0, 0.0, 200.0])
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 0.0, 1.0])
    got = want + ulp * torch.tensor([0.0, 1.0, -2.0, 0.0, 0.0])
    d = equinet_probe.differences(got, want)
    assert d == {"differ_share": pytest.approx(0.4), "max_ulps": 2.0,
                 "nonfinite": 0}
    # against a head output of 4 a unit is 2^-5: the gap of 2^-5 is one
    scale = torch.full_like(want, 4.0)
    assert equinet_probe.differences(got, want, scale)["max_ulps"] == 1.0
    got[3] = float("nan")
    assert equinet_probe.differences(got, want)["nonfinite"] == 1
    assert equinet_probe.differences(want[:0], want[:0])["max_ulps"] == 0.0
