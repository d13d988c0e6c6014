"""rnad_tpu_torch's ConvNet (CrossConv, MaskedBatchNorm, ConvResBlock) against
rnad_tpu's flax ConvNet from the same variables.

Forward in eval mode (running averages), the updated running statistics
and the flax<->torch carrier within atol 1e-5 (rtol 1e-5); forward in train
mode (batch statistics, with no mask, a 0/1 mask and an all-zero mask) and
the gradients of every parameter within 1e-5 of the largest magnitude of
the output or gradient leaf (absolute where that is below 1).  The
convolutions and the two-pass statistics sum in another order in each
package, and an all-zero mask normalizes by a variance of 0, which
rsqrt(var + 1e-5) turns into a factor of 316.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch.config import NetConfig as TorchNetConfig
from rnad_tpu_torch.models import nets as torch_nets
from tests.torch_parity import obs_with_illegal_actions, torch_convnet

TOL = dict(rtol=1e-5, atol=1e-5)


def _close_scaled(got, want, err_msg=""):
    """Within 1e-5 of ``want``'s largest magnitude, or absolute where that
    is below 1."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5,
                               err_msg=err_msg)


def _variables(A, channels, depth, batch_norm, in_channels, seed):
    """rnad_tpu's initial variables with BatchNorm scale, bias and
    statistics moved off their initial 1, 0, 0, 1."""
    net = jax_nets.build_net(NetConfig(type="ConvNet", max_actions=A,
                                       channels=channels, depth=depth,
                                       batch_norm=batch_norm))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(seed), A,
                                        in_channels)
    rng = np.random.default_rng(seed)

    def move(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return jnp.asarray(1.0 + 0.5 * rng.random(x.shape), jnp.float32)
        if name in ("bias", "mean") and "bn" in str(path):
            return jnp.asarray(0.3 * rng.normal(size=x.shape), jnp.float32)
        return jnp.asarray(x)

    return net, jax.tree_util.tree_map_with_path(move, dict(variables))


def _obs(seed, n, A, in_channels):
    obs = obs_with_illegal_actions(seed, n, A)
    if in_channels > 2:  # lifted-like extra channels
        rng = np.random.default_rng(seed + 1)
        extra = rng.normal(size=(n, in_channels - 2, A, A)).astype(np.float32)
        obs = np.concatenate([obs, extra], axis=1)
    return obs


CASES = [(3, 8, 2, True, 2), (3, 4, 1, True, 9), (5, 6, 2, True, 2),
         (3, 8, 2, False, 2)]


@pytest.mark.parametrize("A,channels,depth,batch_norm,in_channels", CASES)
def test_eval_forward_matches(A, channels, depth, batch_norm, in_channels):
    net, variables = _variables(A, channels, depth, batch_norm, in_channels,
                                seed=A + channels)
    obs = _obs(1, 64, A, in_channels)
    want = jax_nets.apply_eval(net, variables, jnp.asarray(obs))
    tnet = torch_convnet(variables, A, channels, depth, batch_norm,
                         in_channels)
    got = tnet(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


MASKS = {"none": None, "half": "half", "zero": "zero"}


def _mask(kind, n, seed):
    if kind is None:
        return None
    if kind == "zero":
        return np.zeros(n, np.float32)
    m = (np.random.default_rng(seed).random(n) < 0.5).astype(np.float32)
    m[0] = 1.0
    return m


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("A,channels,depth,batch_norm,in_channels",
                         CASES[:3])
def test_train_forward_statistics_and_gradients_match(
        A, channels, depth, batch_norm, in_channels, mask_kind):
    net, variables = _variables(A, channels, depth, batch_norm, in_channels,
                                seed=7)
    n = 48
    obs = _obs(2, n, A, in_channels)
    mask = _mask(MASKS[mask_kind], n, 3)
    w = np.random.default_rng(4).normal(size=(n, A + 1)).astype(np.float32)

    def loss(params):
        (logits, v), mutated = jax_nets.apply_train(
            net, dict(variables, params=params), jnp.asarray(obs),
            None if mask is None else jnp.asarray(mask))
        out = jnp.concatenate([logits, v[:, None]], axis=1)
        return jnp.sum(out * w), (logits, v, mutated)

    (_, (logits, v, mutated)), grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])

    tnet = torch_convnet(variables, A, channels, depth, batch_norm,
                         in_channels)
    tl, tv = torch_nets.forward_train(
        tnet, torch.from_numpy(obs),
        None if mask is None else torch.from_numpy(mask))
    # an all-zero mask normalizes by var 0: rsqrt(1e-5) scales outputs up
    _close_scaled(tl.detach().numpy(), np.asarray(logits))
    _close_scaled(tv.detach().numpy(), np.asarray(v))
    (torch.cat([tl, tv[:, None]], 1) * torch.from_numpy(w)).sum().backward()

    got = torch_nets.convnet_to_flax(tnet)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(x) for k, x in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    stats = flat(got["batch_stats"])
    want_stats = flat(mutated["batch_stats"])
    assert set(stats) == set(want_stats) and stats
    for k in want_stats:
        np.testing.assert_allclose(stats[k], want_stats[k], **TOL, err_msg=k)

    gnet = torch_convnet(variables, A, channels, depth, batch_norm,
                         in_channels)
    with torch.no_grad():
        for p, q in zip(gnet.parameters(), tnet.parameters()):
            p.copy_(q.grad)
    tgrads = flat(torch_nets.convnet_to_flax(gnet)["params"])
    want_grads = flat(grads)
    assert set(tgrads) == set(want_grads)
    for k in want_grads:
        _close_scaled(tgrads[k], want_grads[k], err_msg=k)


def test_carrier_round_trip():
    net, variables = _variables(3, 8, 2, True, 9, seed=3)
    tnet = torch_convnet(variables, 3, 8, 2, True, 9)
    back = torch_nets.convnet_to_flax(tnet)
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]
    want = dict((jax.tree_util.keystr(k), np.asarray(x))
                for k, x in flat(dict(variables)))
    got = dict((jax.tree_util.keystr(k), x) for k, x in flat(back))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_net_and_init():
    cfg = TorchNetConfig(type="ConvNet", max_actions=3, channels=8, depth=2)
    net = torch_nets.build_net(cfg, torch.Generator().manual_seed(0), 9)
    again = torch_nets.build_net(cfg, torch.Generator().manual_seed(0), 9)
    for (k, p), q in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(p, q), k
    assert net.pre.row_conv.weight.shape == (8, 9, 1, 5)
    assert net.pre.col_conv.weight.shape == (8, 9, 5, 1)
    bound = 1 / (9 * 5) ** 0.5
    assert net.pre.row_conv.weight.abs().max() <= bound
    assert sorted(k for k, _ in net.named_buffers()) == [
        f"block{i}.bn{j}.{s}" for i in range(2) for j in range(2)
        for s in ("mean", "var")]
    plain = torch_nets.build_net(
        TorchNetConfig(type="ConvNet", max_actions=3, batch_norm=False))
    assert not list(plain.buffers())
    # eval mode, the default forward, leaves the statistics alone
    obs = torch.from_numpy(obs_with_illegal_actions(0, 16, 3))
    before = [b.clone() for b in net.buffers()]
    net(torch.cat([obs, torch.zeros(16, 7, 3, 3)], 1))
    assert all(torch.equal(a, b) for a, b in zip(before, net.buffers()))
