"""rnad_tpu_torch.ops.equinet (kernel K4, the EquiNet's no-grad forwards)
on the CPU: its plain version is the nets' own forwards, the learner's
frozen passes, the rollout's generic turn and NashConv take it only for
what the kernel takes (and keep every other net's eager forwards, tensor
for tensor), and its operation count is the benchmark's.  The kernel
itself is held to the eager forwards on the card
(tests/test_torch_cuda.py).  Every comparison here is bitwise."""

import json

import pytest
import torch

from benchmark.work import equinet as work_equinet
from rnad_tpu_torch.config import (NetConfig, ObsTransformConfig, RNaDConfig,
                                   TreeConfig)
from rnad_tpu_torch.env import engine
from rnad_tpu_torch.env import tree as tree_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.metrics import nashconv
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import equinet as equinet_ops
from rnad_tpu_torch.ops import obs_transform as obs_transform_lib
from rnad_tpu_torch.ops import stepping
from rnad_tpu_torch.parallel import tensor_parallel
from rnad_tpu_torch.parallel.mesh import ModelGroup
from rnad_tpu_torch.utils import timing

N = 37  # not a multiple of any tile
CPU_ONLY = "observations on cpu (the kernel runs on CUDA)"


def _net(A=3, C=16, depth=2, solver_iters=8, prime=True, dtype="bfloat16",
         seed=0, kind="EquiNet", in_channels=2):
    cfg = NetConfig(type=kind, max_actions=A, channels=C, depth=depth,
                    solver_iters=solver_iters, solver_prime=prime,
                    compute_dtype=dtype, width=16)
    net = nets.build_net(cfg, torch.Generator().manual_seed(seed),
                         in_channels)
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


# the nets the no-grad forward (``forward_no_grad``: the rollout's generic
# turn, NashConv) keeps eager: (net, its lift or None, what the gate names)
LIFT = ObsTransformConfig(kind="lift", channels=8, sigma=0.1)


def _lift(A=3):
    return obs_transform_lib.make_obs_transform(LIFT, A)


NO_GRAD = {
    "mlp": (lambda: _net(kind="MLP", dtype="float32"), None,
            "not plain EquiNets"),
    "convnet": (lambda: _net(kind="ConvNet", C=8, depth=1), None,
                "not plain EquiNets"),
    "float32": (lambda: _net(dtype="float32"), None, "dtype"),
    "bfloat16_on_the_cpu": (lambda: _net(), None, CPU_ONLY),
    "tensor_parallel": (lambda: _tensor_parallel(_net()), None,
                        "not plain EquiNets"),
    "lifted": (lambda: _net(in_channels=obs_transform_lib.out_channels(LIFT)),
               _lift, CPU_ONLY),
}


@pytest.mark.parametrize("name", sorted(NO_GRAD))
def test_forward_no_grad_is_the_nets_own_forward(name):
    """The gate names why the kernel does not take the net, and the helper
    returns ``net(obs)`` bit for bit without a launch: on the generic
    turn's observations (lifted ones for a lifted net) and, for a lifted
    net, behind NashConv's noise-free lift (a callable: not an EquiNet)."""
    make, lift, why = NO_GRAD[name]
    net = make()
    obs = _obs(3)
    callers = [(net, obs)]
    if lift is not None:
        transform = lift()
        eps = torch.randn((N, LIFT.channels, 3, 3),
                          generator=torch.Generator().manual_seed(2))
        callers = [(net, transform.apply(obs, eps)),
                   (nashconv.lifted(net, transform), obs)]
    before = equinet_ops.equinet_frozen.launches
    for k, (fn, x) in enumerate(callers):
        feats = equinet_ops.solver_features(fn, x)
        named = equinet_ops.unsupported([fn], x, feats,
                                        getattr(fn, "dtype", None))
        assert (why if k == 0 else "not plain EquiNets") in named
        with torch.no_grad():
            want = fn(x)
        _equal(equinet_ops.forward_no_grad(fn, x), want)
    assert equinet_ops.equinet_frozen.launches == before


def _tree(A=3):
    cfg = TreeConfig(max_actions=A, max_transitions=2,
                     transition_threshold=0.3, depth_bound=3)
    return tree_lib.generate_tree(cfg, seed=0, device="cpu")


def _eager_forward(monkeypatch):
    """``forward_no_grad`` as the generic turn and NashConv ran it before
    K4 took it: the net's own forward."""
    monkeypatch.setattr(equinet_ops, "forward_no_grad",
                        lambda net, obs, *a, **k: net(obs))


def _fields(traj):
    return [traj.indices, traj.policy, traj.actions, traj.rewards,
            traj.values, traj.obs]


@pytest.mark.parametrize("name", sorted(NO_GRAD))
def test_rollout_and_nashconv_are_what_they_were(name, monkeypatch):
    """For every net K4 does not take here (the bf16 EquiNet for being on
    the CPU), the rollout (the generic turn, the MLP's too) and exact
    NashConv (whole-tree and chunked, behind the lift where there is one)
    are bitwise the eager forward's."""
    make, lift, _ = NO_GRAD[name]
    net, tree = make(), _tree()
    transform = lift() if lift is not None else None
    packed = stepping.make_packed_tables(tree)
    init = torch.ones((64,), dtype=torch.int32)

    def run():
        traj = engine.rollout_from(
            tree, packed, net, init, generator=torch.Generator()
            .manual_seed(5), rows_actor="off", obs_transform=transform,
            store_obs=True)
        evals = [rnad.nashconv(tree, net, chunk, transform)
                 for chunk in (None, tree.size // 3 + 1)]
        return _fields(traj) + [t for r in evals
                                for t in (r.row_best, r.col_best)]

    got = run()
    _eager_forward(monkeypatch)
    _equal(got, run())


def test_rollout_and_nashconv_route_the_net_through_the_kernel(
        monkeypatch, tmp_path):
    """Where the kernel engages (here on the CPU, with the gate naming
    nothing and the plain version in the kernel's place), each generic
    turn launches it once on the parameters the rollout packed once,
    inside ``rnad.rollout.forward.fused`` within ``rnad.rollout.forward``,
    and NashConv once a chunk: the same trajectory and values as the
    eager forward."""
    net, tree = _net(A=3, C=16), _tree()
    packed = stepping.make_packed_tables(tree)
    init = torch.ones((64,), dtype=torch.int32)
    chunk = tree.size // 3 + 1
    play = lambda: engine.rollout_from(
        tree, packed, net, init, generator=torch.Generator().manual_seed(5),
        store_obs=True)
    want = _fields(play()) + [rnad.nashconv(tree, net, chunk).row_best]

    packs, launches = [], []
    monkeypatch.setattr(equinet_ops, "unsupported", lambda *a: None)
    monkeypatch.setattr(equinet_ops, "packed_params", lambda n: (
        packs.append(n) or equinet_ops.pack([n])))
    monkeypatch.setattr(equinet_ops, "equinet_frozen", lambda *a, **k: (
        launches.append(k["params"]) or equinet_ops.equinet_frozen_plain(
            *a, values=k.get("values"))))
    with timing.trace(str(tmp_path)):
        got = _fields(play())
    assert len(packs) == 1 and len(launches) == tree.max_depth
    assert all(p is launches[0] and p is not None for p in launches)
    _equal(got, want[:-1])
    launches.clear()
    _equal([rnad.nashconv(tree, net, chunk).row_best], want[-1:])
    assert len(launches) == -(-tree.size // chunk)

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]
    outer = [s for s in spans if s[2] == "rnad.rollout.forward"]
    inner = [s for s in spans if s[2] == "rnad.rollout.forward.fused"]
    assert len(outer) == len(inner) == tree.max_depth
    assert all(o[0] <= i[0] and i[1] <= o[1] for o, i in
               zip(sorted(outer), sorted(inner)))


def test_pack_is_the_kernels_parameter_order():
    """``pack`` lays out each net's leaves in turn; ``packed_params`` packs
    only what the kernel may take (a plain bf16 EquiNet on a card)."""
    a, b = _net(seed=0), _net(seed=1)
    want = torch.cat([t.reshape(-1) for n in (a, b)
                      for t in equinet_ops.leaves(n)])
    assert torch.equal(equinet_ops.pack([a, b]), want)
    assert equinet_ops.pack([a]).numel() * 2 == want.numel()
    for net in (a, _net(dtype="float32"), _net(kind="MLP"),
                _tensor_parallel(_net())):
        assert equinet_ops.packed_params(net) is None  # all on the CPU
