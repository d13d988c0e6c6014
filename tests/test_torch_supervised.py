"""rnad_tpu_torch.learn.supervised against rnad_tpu.learn.supervised.

On the session's small tree (A = 3, depth 3), from rnad_tpu's init carried
over to the port, for the depth-1 MLP and a primed EquiNet with 8 RM+
iterations (the EquiNet solving with rnad_tpu's RM+ loop, ``jax_solve``:
float32 solves summed in another order part on a few of the tree's games):

- the dataset is equal, bitwise;
- the loss at the same weights agrees within 1e-6;
- 50 full-batch Adam steps end on the same final loss within 1e-4, the
  same policy and values at every node within 1e-4 and the same NashConv
  within 1e-4 (float32 sums in another order, compounded over 50 steps),
  and for the MLP on weights within 1e-4.  The EquiNet's policy-head bias
  (and its weights on row-constant pools) shifts a row's logits alike: the
  loss's gradient there is 0 but for rounding, which Adam scales to steps
  of up to lr in either package, so its weights are compared through what
  they compute;
- 30 minibatched steps fed rnad_tpu's row draws (``jax.random.randint`` on
  ``split(fold_in(key, 1), steps)``) do the same;
- the chunked final NashConv equals the whole-tree one (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.learn import supervised as jax_sup
from rnad_tpu.models import common as jax_common
from rnad_tpu.models import nets as jax_nets
from rnad_tpu_torch.learn import supervised as torch_sup
from rnad_tpu_torch.models import common as torch_common
from rnad_tpu_torch.models import nets as torch_nets
from tests.torch_parity import jax_solve, torch_tree

A = 3
NETS = {
    "mlp": dict(type="MLP", max_actions=A, width=32),
    "equinet": dict(type="EquiNet", max_actions=A, channels=8, depth=2,
                    solver_iters=8, solver_prime=True),
}


@pytest.fixture(autouse=True)
def _jax_solves(monkeypatch):
    monkeypatch.setattr(torch_nets.solver_device, "solve_zero_sum_rmplus",
                        jax_solve)


def _pair(kind, seed=0):
    cfg = NetConfig(**NETS[kind])
    net = jax_nets.build_net(cfg)
    key = jax.random.PRNGKey(seed)
    variables = jax_nets.init_variables(net, key, A)
    tnet = torch_nets.build_net(_torch_cfg(cfg))
    tnet.load_state_dict(torch_nets.params_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    return net, key, variables, tnet


def _torch_cfg(cfg):
    from rnad_tpu_torch import config as torch_config

    return torch_config.NetConfig(**cfg.to_json())


def _param_gap(tnet, params):
    got = torch_nets.params_to_flax(tnet)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(x) for k, x in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(params)
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _output_gap(tnet, net, params, small_tree):
    """Largest difference of the masked policy and the value between the
    two packages' nets over every node and seat."""
    obs = jax_sup._dataset(small_tree)[0].reshape(-1, 2, A, A)
    logits, value = jax_nets.apply_eval(net, {"params": params}, obs)
    legal = obs[:, 1, :, 0]
    pol = jax_common.masked_policy(logits, legal)
    tobs = torch.from_numpy(np.array(obs))
    with torch.no_grad():
        tlogits, tvalue = tnet(tobs)
    tpol = torch_common.masked_policy(tlogits, tobs[:, 1, :, 0])
    return max(float(np.abs(tpol.numpy() - np.asarray(pol)).max()),
               float(np.abs(tvalue.numpy() - np.asarray(value)).max()))


def _assert_trained_alike(tnet, tmetrics, net, new, metrics, small_tree,
                          kind):
    assert abs(tmetrics["final_loss"] - metrics["final_loss"]) <= 1e-4
    assert abs(tmetrics["nashconv"] - metrics["nashconv"]) <= 1e-4
    assert _output_gap(tnet, net, new["params"], small_tree) <= 1e-4
    if kind == "mlp":
        assert _param_gap(tnet, new["params"]) <= 1e-4


def test_dataset_equal(small_tree):
    want = jax_sup._dataset(small_tree)
    got = torch_sup.dataset(torch_tree(small_tree))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", sorted(NETS))
def test_loss_matches(small_tree, kind):
    net, _, variables, tnet = _pair(kind)
    data = jax_sup._dataset(small_tree)
    want, parts = jax_sup.supervised_loss(variables["params"], {}, net,
                                          *data)
    got, tparts = torch_sup.supervised_loss(
        tnet, *torch_sup.dataset(torch_tree(small_tree)))
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    for k in ("loss_pi", "loss_v"):
        assert abs(float(tparts[k].detach()) - float(parts[k])) <= 1e-6, k


@pytest.mark.parametrize("kind", sorted(NETS))
def test_full_batch_training_matches(small_tree, kind):
    net, key, variables, tnet = _pair(kind, seed=1)
    new, metrics = jax_sup.train_oracle_net(small_tree, net, key, steps=50,
                                            lr=3e-3, variables=variables)
    _, tmetrics = torch_sup.train_oracle_net(torch_tree(small_tree), tnet,
                                             steps=50, lr=3e-3)
    _assert_trained_alike(tnet, tmetrics, net, new, metrics, small_tree,
                          kind)


def _jax_batch_indices(key, steps, node_batch, n_rows):
    keys = jax.random.split(jax.random.fold_in(key, 1), steps)
    return [torch.from_numpy(np.array(
        jax.random.randint(k, (node_batch,), 0, n_rows))).long()
        for k in keys]


@pytest.mark.parametrize("kind", sorted(NETS))
def test_minibatched_training_with_fed_indices_matches(small_tree, kind):
    net, key, variables, tnet = _pair(kind, seed=2)
    steps, node_batch = 30, 96
    new, metrics = jax_sup.train_oracle_net(
        small_tree, net, key, steps=steps, lr=3e-3, variables=variables,
        node_batch=node_batch)
    n_rows = 2 * small_tree.index.shape[0]
    _, tmetrics = torch_sup.train_oracle_net(
        torch_tree(small_tree), tnet, steps=steps, lr=3e-3,
        node_batch=node_batch,
        batch_indices=_jax_batch_indices(key, steps, node_batch, n_rows))
    _assert_trained_alike(tnet, tmetrics, net, new, metrics, small_tree,
                          kind)


def test_minibatches_come_from_the_generator(small_tree):
    tree = torch_tree(small_tree)
    runs = []
    for seed in (0, 0, 1):
        _, _, _, tnet = _pair("mlp", seed=3)
        _, m = torch_sup.train_oracle_net(
            tree, tnet, steps=5, lr=3e-3, node_batch=32,
            generator=torch.Generator().manual_seed(seed))
        runs.append(m["final_loss"])
    assert runs[0] == runs[1] != runs[2]


@pytest.mark.parametrize("kind", sorted(NETS))
def test_chunked_eval_matches_whole_tree(small_tree, kind):
    tree = torch_tree(small_tree)
    out = []
    for chunk in (None, max(2, tree.size // 3)):
        _, _, _, tnet = _pair(kind, seed=4)
        _, m = torch_sup.train_oracle_net(tree, tnet, steps=20, lr=3e-3,
                                          eval_chunk_nodes=chunk)
        out.append(m)
    assert out[0]["final_loss"] == out[1]["final_loss"]
    np.testing.assert_allclose(out[1]["nashconv"], out[0]["nashconv"],
                               rtol=0, atol=1e-6)
