"""rnad_tpu_torch.models against rnad_tpu.models: the weight carrier, the
MLP forward, the fused-weight forms and the masked policy math, float32 at
atol 1e-6 (matmul reduction order differs between XLA and torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.models import common as jax_common
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch.config import NetConfig as TorchNetConfig
from rnad_tpu_torch.models import common as torch_common
from rnad_tpu_torch.models import nets as torch_nets
from tests.torch_parity import torch_mlp

A, WIDTH = 3, 32


@pytest.fixture(scope="module")
def nets_pair():
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(0), A)
    return net, variables, torch_mlp(variables["params"], A, WIDTH)


def _obs(seed, n=257):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 2, A, A)).astype(np.float32)
    obs[:, 1] = rng.random((n, A, A)) < 0.7
    obs[:, 1, 0, 0] = 1.0
    return obs


def test_carrier_round_trip(nets_pair):
    _, variables, tnet = nets_pair
    back = torch_nets.params_to_flax(tnet)
    params = variables["params"]
    assert set(back) == set(params)
    for layer in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[layer][leaf],
                                          np.asarray(params[layer][leaf]))
    assert tnet.policy_fc0.weight.shape == (WIDTH, 2 * A * A)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_apply_eval(nets_pair, seed):
    net, variables, tnet = nets_pair
    obs = _obs(seed)
    logits_w, v_w = jax_nets.apply_eval(net, variables, jnp.asarray(obs))
    with torch.no_grad():
        logits_g, v_g = tnet(torch.from_numpy(obs))
    np.testing.assert_allclose(logits_g.numpy(), np.asarray(logits_w),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(v_g.numpy(), np.asarray(v_w), rtol=0,
                               atol=1e-6)


def test_fused_weights_and_head_eval(nets_pair):
    net, variables, tnet = nets_pair
    want = jax_nets.mlp_fused_weights(variables["params"], A)
    got = torch_nets.mlp_fused_weights(tnet)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    obs = _obs(3).reshape(-1, 2 * A * A)
    for head in ("policy", "value"):
        w = jax_nets.mlp_head_eval(net, variables["params"],
                                   jnp.asarray(obs), head)
        with torch.no_grad():
            g = torch_nets.mlp_head_eval(tnet, torch.from_numpy(obs), head)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_masked_policy_math():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(64, A)).astype(np.float32) * 3
    legal = (rng.random((64, A)) < 0.6).astype(np.float32)
    legal[:, 1] = 1.0
    tl, tg = torch.from_numpy(logits), torch.from_numpy(legal)
    jl, jg = jnp.asarray(logits), jnp.asarray(legal)
    for fw, fg in ((jax_common.masked_policy, torch_common.masked_policy),
                   (jax_common.masked_log_policy,
                    torch_common.masked_log_policy)):
        np.testing.assert_allclose(fg(tl, tg).numpy(), np.asarray(fw(jl, jg)),
                                   rtol=0, atol=1e-6)
    lp = torch_common.masked_log_policy(tl, tg).numpy()
    assert (lp[legal == 0] == 0.0).all()
    np.testing.assert_array_equal(
        torch_common.masked_logits(tl, tg).numpy(),
        np.asarray(jax_common.masked_logits(jl, jg)))


def test_init_is_torch_linear_default():
    cfg = TorchNetConfig(max_actions=A, width=WIDTH)
    net = torch_nets.build_net(cfg, torch.Generator().manual_seed(0))
    again = torch_nets.build_net(cfg, torch.Generator().manual_seed(0))
    for name in ("policy_fc0", "policy_fc1", "value_fc0", "value_fc1"):
        layer = getattr(net, name)
        bound = 1.0 / layer.in_features ** 0.5
        for p in (layer.weight, layer.bias):
            assert float(p.detach().abs().max()) <= bound
        torch.testing.assert_close(layer.weight, getattr(again, name).weight,
                                   rtol=0, atol=0)
