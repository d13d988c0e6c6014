"""rnad_tpu_torch's EquiNet against rnad_tpu's: forward and gradients,
symmetry, the primed heads, shared solver features, the weight carrier and
the inference chunk size.

Tolerances: logits, values and gradients within atol 1e-5 (float32 sums in
another order).  The net comparisons feed both nets the same solver
features (rnad_tpu's), so they hold the net alone; the solve itself is held
by tests/test_torch_rmplus.py.  End to end, each package solves for itself:
outputs agree within 1e-5 except on games whose float32 RM+ runs diverged
(counted, as ``solver_device.agreement`` counts them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch.config import NetConfig as TorchNetConfig
from rnad_tpu_torch.env import solver_device as torch_sd
from rnad_tpu_torch.models import common as torch_common
from rnad_tpu_torch.models import nets as torch_nets
from tests.torch_parity import obs_with_illegal_actions, torch_equinet

A, CH, DEPTH = 5, 16, 3
CASES = [(0, False), (16, False), (32, True)]


def _pair(solver_iters, solver_prime, seed=0, depth=DEPTH):
    net = jax_nets.build_net(NetConfig(type="EquiNet", max_actions=A,
                                       channels=CH, depth=depth,
                                       solver_iters=solver_iters,
                                       solver_prime=solver_prime))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(seed), A)
    if solver_prime:  # move the zero-initialized heads off zero
        variables = jax.tree.map(lambda p: p, variables)
        params = dict(variables["params"])
        rng = np.random.default_rng(seed)
        for head in ("policy", "value"):
            params[head] = jax.tree.map(
                lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.1,
                                      jnp.float32), params[head])
        variables = {"params": params}
    tnet = torch_equinet(variables["params"], A, CH, depth, solver_iters,
                         solver_prime)
    return net, variables, tnet


def _feats_to_torch(feats):
    return tuple(torch.from_numpy(np.array(f)) for f in feats)


@pytest.mark.parametrize("solver_iters,solver_prime", CASES)
def test_forward_matches(solver_iters, solver_prime):
    net, variables, tnet = _pair(solver_iters, solver_prime)
    obs = obs_with_illegal_actions(0, 257, A)
    kw, tkw = {}, {}
    if solver_iters:
        feats = jax_nets.equinet_solver_features(net, jnp.asarray(obs))
        kw = {"solver_feats": feats}
        tkw = {"solver_feats": _feats_to_torch(feats)}
    logits_w, v_w = jax_nets.apply_eval(net, variables, jnp.asarray(obs),
                                        **kw)
    with torch.no_grad():
        logits_g, v_g = tnet(torch.from_numpy(obs), **tkw)
    assert logits_g.shape == (257, A) and v_g.shape == (257,)
    np.testing.assert_allclose(logits_g.numpy(), np.asarray(logits_w),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(v_g.numpy(), np.asarray(v_w), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("solver_iters,solver_prime", CASES[1:])
def test_forward_end_to_end(solver_iters, solver_prime):
    """Each package runs its own solve inside the forward."""
    net, variables, tnet = _pair(solver_iters, solver_prime)
    obs = obs_with_illegal_actions(1, 257, A)
    logits_w, v_w = (np.asarray(a) for a in jax_nets.apply_eval(
        net, variables, jnp.asarray(obs)))
    with torch.no_grad():
        logits_g, v_g = (a.numpy() for a in tnet(torch.from_numpy(obs)))
    legal = obs[:, 1]
    lr, lc = legal.max(2), legal.max(1)
    feats_w = jax_nets.equinet_solver_features(net, jnp.asarray(obs))
    xw = np.asarray(feats_w[0])[:, :, 0, 0]
    yw = np.asarray(feats_w[0])[:, 0, :, 3]
    feats_g = torch_nets.equinet_solver_features(tnet, torch.from_numpy(obs))
    xg, yg = feats_g[0][:, :, 0, 0], feats_g[0][:, 0, :, 3]
    t = lambda a: torch.from_numpy(np.array(a))
    solves = torch_sd.agreement(t(obs[:, 0]), t(lr), t(lc), (xg, yg),
                                (t(xw), t(yw)), feats_g[2], t(feats_w[2]))
    assert solves.ok, solves
    err = np.maximum(np.abs(logits_g - logits_w).max(1),
                     np.abs(v_g - v_w))
    # where the solves agree the nets agree, up to log x's amplification
    # of the solves' own float32 differences on tiny probabilities
    off = err > 1e-5
    assert off.sum() <= max(solves.diverged, 1) + int(0.03 * len(err)), (
        off.sum(), solves)


def test_gradients_match():
    """d(loss)/d(every parameter) of a scalar loss of logits and values
    (a mean over the batch, as the trainer's losses are), on observations
    with illegal actions (so the max pools tie)."""
    net, variables, tnet = _pair(32, True, seed=3)
    obs = obs_with_illegal_actions(4, 129, A)
    feats = jax_nets.equinet_solver_features(net, jnp.asarray(obs))
    rng = np.random.default_rng(5)
    wl = rng.normal(size=(129, A)).astype(np.float32)
    wv = rng.normal(size=(129,)).astype(np.float32)

    def loss(params):
        logits, v = jax_nets.apply_eval(net, {"params": params},
                                        jnp.asarray(obs), solver_feats=feats)
        masked = jnp.where(jnp.asarray(obs[:, 1, :, 0]) > 0, logits, 0.0)
        return jnp.mean(masked * wl) + jnp.mean(jnp.tanh(v) * wv)

    grads = jax.grad(loss)(variables["params"])
    logits, v = tnet(torch.from_numpy(obs), _feats_to_torch(feats))
    masked = torch.where(torch.from_numpy(obs[:, 1, :, 0]) > 0, logits,
                         torch.zeros_like(logits))
    tloss = (masked * torch.from_numpy(wl)).mean() + (
        torch.tanh(v) * torch.from_numpy(wv)).mean()
    tloss.backward()
    got = torch_nets.params_to_flax(
        _GradView(tnet))  # gradients in the flax layout
    want = jax.tree.map(np.asarray, grads)
    assert set(got) == set(want)
    for name in want:
        leaves = want[name] if isinstance(want[name], dict) else {
            None: want[name]}
        for leaf, w in leaves.items():
            g = got[name] if leaf is None else got[name][leaf]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{leaf}")


class _GradView(torch.nn.Module):
    """A module whose state_dict holds another module's gradients."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def state_dict(self, *args, **kwargs):
        return {k: p.grad for k, p in self.net.named_parameters()}


@pytest.mark.parametrize("solver_iters,solver_prime", CASES)
def test_equivariance(solver_iters, solver_prime):
    """Permuting the mover's actions (obs rows) by sigma and the opponent's
    (obs cols) by tau permutes the logits by sigma and keeps the value
    (tests/test_models.py::test_equinet_equivariance)."""
    tnet = torch_nets.build_net(
        TorchNetConfig(type="EquiNet", max_actions=A, channels=CH,
                       depth=DEPTH, solver_iters=solver_iters,
                       solver_prime=solver_prime),
        torch.Generator().manual_seed(0))
    obs = torch.from_numpy(obs_with_illegal_actions(2, 11, A))
    rng = np.random.default_rng(3)
    sigma = torch.from_numpy(rng.permutation(A))
    tau = torch.from_numpy(rng.permutation(A))
    with torch.no_grad():
        logits, value = tnet(obs)
        logits_p, value_p = tnet(obs[:, :, sigma][:, :, :, tau])
    torch.testing.assert_close(logits_p, logits[:, sigma], rtol=0, atol=1e-5)
    torch.testing.assert_close(value_p, value, rtol=0, atol=1e-5)


def test_primed_starts_at_solver():
    """Zero heads and unit gates: the untrained policy is the RM+ solution
    and the value its game value."""
    tnet = torch_nets.build_net(
        TorchNetConfig(type="EquiNet", max_actions=A, channels=CH, depth=2,
                       solver_iters=32, solver_prime=True),
        torch.Generator().manual_seed(0))
    assert float(tnet.policy_prime_gate.detach()) == 1.0
    assert float(tnet.policy.weight.detach().abs().sum()) == 0.0
    obs = torch.from_numpy(obs_with_illegal_actions(5, 9, A))
    with torch.no_grad():
        logits, value = tnet(obs)
    legal = obs[:, 1]
    lr, lc = legal.amax(2), legal.amax(1)
    xs, _, v = torch_sd.solve_zero_sum_rmplus(obs[:, 0], lr, lc, iters=32)
    policy = torch_common.masked_policy(logits, lr)
    torch.testing.assert_close(policy, xs, rtol=0, atol=1e-5)
    torch.testing.assert_close(value, v, rtol=0, atol=1e-5)


def test_shared_solver_features_bitwise():
    tnet = torch_nets.build_net(
        TorchNetConfig(type="EquiNet", max_actions=4, channels=8, depth=2,
                       solver_iters=24, solver_prime=True),
        torch.Generator().manual_seed(0))
    obs = torch.from_numpy(obs_with_illegal_actions(6, 13, 4))
    with torch.no_grad():
        logits, value = tnet(obs)
        feats = torch_nets.equinet_solver_features(tnet, obs)
        logits_s, value_s = tnet(obs, feats)
    assert torch.equal(logits, logits_s) and torch.equal(value, value_s)


@pytest.mark.parametrize("solver_iters,solver_prime", CASES)
def test_carrier_round_trip(solver_iters, solver_prime):
    net, variables, tnet = _pair(solver_iters, solver_prime)
    back = torch_nets.params_to_flax(tnet)
    params = jax.tree.map(np.asarray, variables["params"])
    assert set(back) == set(params)
    for name, layer in params.items():
        if isinstance(layer, dict):
            for leaf in layer:
                np.testing.assert_array_equal(back[name][leaf], layer[leaf])
        else:
            np.testing.assert_array_equal(back[name], layer)
    cin = 2 + (6 if solver_iters else 0)
    assert tnet.ex0.kernel.shape == (6 * cin, CH)  # flax layout, no transpose
    assert tnet.policy.weight.shape == (1, CH + cin)


def test_init_distribution():
    tnet = torch_nets.build_net(
        TorchNetConfig(type="EquiNet", max_actions=A, channels=64, depth=2,
                       solver_iters=8),
        torch.Generator().manual_seed(0))
    bound0 = 1.0 / (6 * 8) ** 0.5
    assert float(tnet.ex0.kernel.abs().max()) <= bound0
    assert float(tnet.ex1.bias.abs().max()) <= 1.0 / (6 * 64) ** 0.5
    assert float(tnet.policy.weight.abs().max()) <= 1.0 / (64 + 8) ** 0.5
    assert not hasattr(tnet, "policy_prime_gate")


@pytest.mark.parametrize("cfg", [
    dict(type="EquiNet", max_actions=5, channels=64, depth=2,
         solver_iters=128, solver_prime=True),
    dict(type="EquiNet", max_actions=5, channels=128, depth=4),
    dict(type="EquiNet", max_actions=3, channels=16, depth=1,
         solver_iters=16),
    dict(type="MLP", max_actions=5, width=256),
    dict(type="MLP", max_actions=3, width=4096),
    # bfloat16: flagship-3's net (20,971-node chunks), a wide EquiNet, an MLP
    dict(type="EquiNet", max_actions=5, channels=64, depth=2,
         solver_iters=128, solver_prime=True, compute_dtype="bfloat16"),
    dict(type="EquiNet", max_actions=5, channels=128, depth=4,
         compute_dtype="bfloat16"),
    dict(type="MLP", max_actions=3, width=4096, compute_dtype="bfloat16"),
    # the deep MLP (its width alone sets the chunk) and the bf16 ConvNet
    dict(type="MLP", max_actions=3, width=4096, depth=3),
    dict(type="MLP", max_actions=5, width=256, depth=2,
         compute_dtype="bfloat16"),
    dict(type="ConvNet", max_actions=3, channels=16, depth=2,
         compute_dtype="bfloat16"),
    dict(type="ConvNet", max_actions=5, channels=128, depth=4,
         compute_dtype="bfloat16"),
    # the ConvNet: noisy-conv's net, and a wide one at A = 5
    dict(type="ConvNet", max_actions=3, channels=16, depth=2),
    dict(type="ConvNet", max_actions=5, channels=128, depth=4),
])
def test_inference_chunk_nodes_matches(cfg):
    want = jax_nets.inference_chunk_nodes(jax_nets.build_net(NetConfig(**cfg)),
                                          cfg["max_actions"])
    got = torch_nets.inference_chunk_nodes(
        torch_nets.build_net(TorchNetConfig(**cfg)), cfg["max_actions"])
    assert got == want


def test_other_families_raise():
    """The ConvNet builds in bfloat16 too (its forward is held by
    tests/test_torch_nets_depth_dtype.py); an unknown family raises
    rnad_tpu's error."""
    conv = torch_nets.build_net(TorchNetConfig(type="ConvNet", max_actions=3,
                                               compute_dtype="bfloat16"))
    assert isinstance(conv, torch_nets.ConvNet)
    assert conv.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in conv.parameters())
    with pytest.raises(ValueError, match="unknown net type: ResNet"):
        torch_nets.build_net(TorchNetConfig(type="ResNet", max_actions=3))
