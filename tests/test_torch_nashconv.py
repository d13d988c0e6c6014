"""rnad_tpu_torch.metrics.nashconv against rnad_tpu.metrics.nashconv: the
stored solution scores 0 (|NashConv| < 1e-5) and any joint policy gets the
same best-response values and reach probabilities within atol 1e-5
(float32 sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.metrics import nashconv as jax_nashconv
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.metrics import nashconv as torch_nashconv
from tests.torch_parity import torch_mlp, torch_tree

TOL = dict(rtol=0, atol=1e-5)


def test_stored_solution_is_exact(small_tree):
    tree = torch_tree(small_tree)
    result = torch_nashconv.nashconv_pure(tree, tree.solution)
    assert abs(float(result.nashconv())) < 1e-5
    # the best responses against the equilibrium are the game values
    np.testing.assert_allclose(result.row_best[1].item(),
                               tree.root_value[1, 0].item(), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_joint_policy_matches(small_tree, seed):
    tree = torch_tree(small_tree)
    rng = np.random.default_rng(seed)
    A = small_tree.max_actions
    raw = rng.random((small_tree.size, 2 * A)).astype(np.float32)
    joint = np.concatenate([raw[:, :A] / raw[:, :A].sum(1, keepdims=True),
                            raw[:, A:] / raw[:, A:].sum(1, keepdims=True)], 1)
    want = jax_nashconv.nashconv(small_tree, jnp.asarray(joint))
    got = torch_nashconv.nashconv_pure(tree, torch.from_numpy(joint))
    for f in ("row_best", "col_best", "reach_probability"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    np.testing.assert_allclose(float(got.nashconv()),
                               float(want.nashconv()), **TOL)
    by_depth_w = jax_nashconv.mean_nashconv_by_depth(small_tree, want)
    by_depth_g = torch_nashconv.mean_nashconv_by_depth(tree, got)
    assert by_depth_g.keys() == by_depth_w.keys()
    for d in by_depth_w:
        assert abs(by_depth_g[d] - by_depth_w[d]) < 1e-5


def test_net_policy_and_kld_match(small_tree):
    A, width = small_tree.max_actions, 32
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=width))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(2), A)
    apply = lambda vs, obs: jax_nets.apply_eval(net, vs, obs)
    want = jax_nashconv.joint_policy_all_nodes(small_tree, apply, variables)
    tnet = torch_mlp(variables["params"], A, width)
    tree = torch_tree(small_tree)
    got = torch_nashconv.joint_policy_all_nodes(tree, tnet)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the trainer's eval hook scores the same policy
    hook = torch_rnad.nashconv(tree, tnet)
    ref = jax_nashconv.nashconv_root(small_tree, want)
    np.testing.assert_allclose(float(hook.nashconv()), float(ref.nashconv()),
                               **TOL)

    rng = np.random.default_rng(3)
    T, B = 4, 32
    legal = (rng.random((T, B, A)) < 0.7).astype(np.float32)
    legal[..., 0] = 1
    p = rng.random((T, B, A)).astype(np.float32) * legal
    p /= p.sum(-1, keepdims=True)
    q = legal / legal.sum(-1, keepdims=True)
    valid = (rng.random((T, B)) < 0.8).astype(np.float32)
    kw = jax_nashconv.kld(jnp.asarray(p), jnp.asarray(q), jnp.asarray(valid),
                          jnp.asarray(legal))
    kg = torch_nashconv.kld(*(torch.from_numpy(x) for x in (p, q, valid,
                                                           legal)))
    np.testing.assert_allclose(kg.item(), float(kw), rtol=1e-5, atol=1e-7)
