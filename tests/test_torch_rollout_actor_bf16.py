"""The bf16-operand rows-actor (``rollout_actor_dtype="bfloat16"``, kernel
K1's bf16 variant) against rnad_tpu's ``make_mlp_rows_actor(compute_dtype=
bfloat16)``.

On the CPU the port runs K1's plain version: the row and the hidden
activation rounded to bfloat16, the weights cast to bfloat16 once, the
products and sums in float32, the biases in float32.

- Its masked logits and values equal rnad_tpu's rows-actor within 1e-6
  (measured: at most 6e-8; both sum exact products in another order), and
  part from the float32 actor's by more than 1e-4 (bfloat16 rounding).
- Fed rnad_tpu's noise, its rollout plays the same episodes (policy and
  values within 1e-6), as K1's float32 rollout does
  (tests/test_torch_engine.py); no lane parts at these seeds.
- One fused train step with the bf16 actor equals rnad_tpu's (weights
  within atol 1e-6, losses within rtol 1e-5, as tests/test_torch_rnad.py).
- The route: only the depth-1 float32 MLP's K1 reads the dtype (every
  other net rolls out as before), and "on" raises rnad_tpu's errors.
- ``RNaD`` with the bf16 actor constructs and trains on the CPU.
- ``fused_turn.check_bf16``, which holds the bf16 K1 on the card, takes a
  turn whose sums run in the CUDA-core order (the f32 variant's), and one
  whose first layer sums in the tensor cores' order under the model that
  ``fused_turn.bf16_band`` states (groups of 4, 8 or 16 exact products
  added to the accumulator, aligned to the largest and truncated, the sum
  truncated), and rejects either when it leaves the row or the hidden
  activation unrounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig, RNaDConfig
from rnad_tpu.env import engine as jax_engine
from rnad_tpu.learn import rnad as jax_rnad
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch import config as torch_config
from rnad_tpu_torch.env import tree as torch_tree_lib
from rnad_tpu_torch.env import engine as torch_engine
from rnad_tpu_torch.learn import rnad as torch_rnad
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import (rollout_noise, torch_mlp, torch_tree,
                                train_step_noise)

A, WIDTH, B = 3, 32, 256
CFG = dict(batch_size=B, eta=0.2, bounds=(2,), delta_m=(4,), lr=1e-3,
           gamma_averaging=0.01, logit_clip=2.0)


def _net(seed):
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    return net, jax_nets.init_variables(net, jax.random.PRNGKey(seed), A)


def _bf16_weights(tnet):
    w0, b0, w1, b1 = [w.detach() for w in torch_nets.mlp_fused_weights(tnet)]
    return w0.bfloat16(), b0, w1.bfloat16(), b1


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_logits_match_rows_actor(small_tree, seed):
    net, variables = _net(seed)
    packed = jax_stepping.make_packed_tables(small_tree)
    apply = jax_engine.make_mlp_rows_actor(
        net, packed, compute_dtype=jnp.bfloat16)(variables)
    idx = np.random.default_rng(seed).integers(
        0, small_tree.index.shape[0], 4096).astype(np.int32)
    logits, values = apply(packed.rows[idx])
    tpacked = torch_stepping.make_packed_tables(torch_tree(small_tree))
    tnet = torch_mlp(variables["params"], A, WIDTH)
    _, ml, mask, tvalues = fused_turn_lib.turn_logits_plain(
        tpacked.rows, *_bf16_weights(tnet), torch.from_numpy(idx), A=A)
    legal = mask.numpy() > 0
    want = np.asarray(logits).reshape(2 * len(idx), A)
    np.testing.assert_allclose(ml.numpy()[legal], want[legal], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tvalues.numpy(),
                               np.asarray(values).reshape(-1), rtol=0,
                               atol=1e-6)
    w0, b0, w1, b1 = [w.detach() for w in torch_nets.mlp_fused_weights(tnet)]
    _, ml32, _, _ = fused_turn_lib.turn_logits_plain(
        tpacked.rows, w0, b0, w1, b1, torch.from_numpy(idx), A=A)
    assert float((ml - ml32).abs()[mask > 0].max()) > 1e-4


@pytest.mark.parametrize("seed", [3, 11])
def test_rollout_same_episodes(small_tree, seed):
    net, variables = _net(seed)
    packed = jax_stepping.make_packed_tables(small_tree)
    key = jax.random.PRNGKey(seed)
    want = jax_engine.rollout_from(
        small_tree, None, variables, key, jnp.ones((B,), jnp.int32),
        small_tree.max_depth, packed,
        rows_actor=jax_engine.make_mlp_rows_actor(
            net, packed, compute_dtype=jnp.bfloat16))
    tree = torch_tree(small_tree)
    noise = rollout_noise(key, B, A, small_tree.max_transitions,
                          small_tree.max_depth)
    got = torch_engine.rollout_from(
        tree, torch_stepping.make_packed_tables(tree),
        torch_mlp(variables["params"], A, WIDTH),
        torch.ones((B,), dtype=torch.int32), noise=noise,
        actor_dtype=torch.bfloat16)
    for f in ("indices", "actions", "rewards"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("values", "policy"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


def test_train_step_matches(small_tree):
    cfg = RNaDConfig(**CFG, rollout_actor_dtype="bfloat16")
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    step, _, _, _ = jax_rnad.make_rnad_fns(net, small_tree, cfg)
    state = jax_rnad.init_train_state(net, jax.random.PRNGKey(6), A, cfg)
    noise = train_step_noise(state.key, B, A, small_tree.max_transitions,
                             small_tree.max_depth)
    new, metrics = step(state, jnp.float32(0.5))
    tree = torch_tree(small_tree)
    tcfg = torch_config.RNaDConfig(**CFG, rollout_actor_dtype="bfloat16")
    tstate = torch_rnad.init_train_state(
        torch_mlp(state.variables["params"], A, WIDTH), torch.Generator())
    tstep = torch_rnad.make_train_step(
        tree, torch_stepping.make_packed_tables(tree), tcfg)
    _, tmetrics = tstep(tstate, 0.5, noise)
    for k in ("loss", "loss_v", "loss_nerd", "actor_learner_kld"):
        np.testing.assert_allclose(tmetrics[k].item(), float(metrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    got = torch_nets.params_to_flax(tstate.net)
    want = new.variables["params"]
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(want[layer][leaf]),
                                       rtol=0, atol=1e-6)


def test_only_the_k1_route_reads_the_dtype():
    bf16 = torch.bfloat16
    mlp = torch_nets.MLP(A, 8)
    assert torch_engine.uses_fused_turn(mlp, "auto", actor_dtype=bf16)
    assert not torch_engine.uses_fused_turn(mlp, "off", actor_dtype=bf16)
    for net in (torch_nets.MLP(A, 8, depth=2),
                torch_nets.MLP(A, 8, dtype=torch.bfloat16),
                torch_nets.EquiNet(A, channels=4, depth=1)):
        assert not torch_engine.uses_fused_turn(net, "auto",
                                                actor_dtype=bf16)
    assert not torch_engine.uses_fused_turn(mlp, "auto", transform=True,
                                            actor_dtype=bf16)


@pytest.mark.parametrize("net_cfg,dtype", [
    (NetConfig(type="EquiNet", max_actions=A, channels=4, depth=1),
     "bfloat16"),
    (NetConfig(max_actions=A, width=8, depth=2), "bfloat16"),
    (NetConfig(max_actions=A, width=8), "float16"),
])
def test_route_errors_match(small_tree, net_cfg, dtype):
    cfg = RNaDConfig(rollout_rows_actor="on", rollout_actor_dtype=dtype)
    with pytest.raises(ValueError) as want:
        jax_rnad.make_rnad_fns(jax_nets.build_net(net_cfg), small_tree, cfg)
    tcfg = torch_config.RNaDConfig(rollout_rows_actor="on",
                                   rollout_actor_dtype=dtype)
    with pytest.raises(ValueError) as got:
        torch_rnad.RNaD(torch_tree(small_tree), tcfg, torch_config.NetConfig(
            **net_cfg.to_json()), device="cpu").initialize()
    assert str(got.value) == str(want.value)


def test_rnad_trains_with_the_bf16_actor(small_tree, tmp_path):
    tcfg = torch_config.RNaDConfig(batch_size=64, bounds=(1,), delta_m=(3,),
                                   lr=1e-3, rollout_actor_dtype="bfloat16")
    run = torch_rnad.RNaD(torch_tree(small_tree), tcfg,
                          torch_config.NetConfig(max_actions=A, width=16),
                          runs_root=str(tmp_path), device="cpu")
    run.run(log_mod=1)
    assert run.state.total_steps == 3
    assert all(np.isfinite(v) for _, m in run.history for v in m.values())
    assert np.isfinite(run.final_eval())


def _in_index_order(x, w0f):
    """The first layer's sums as the CUDA cores run them: each hidden
    unit's products added in index order from 0 (a product of two bfloat16
    values is exact, so each add rounds as an fmaf does)."""
    acc = torch.zeros((x.shape[0], w0f.shape[1]))
    for k in range(x.shape[1]):
        acc = acc + x[:, k:k + 1] * w0f[k]
    return acc


def _truncated(v, exponent):
    """``v`` (float64) with the bits below 2^(exponent - 24) dropped,
    toward zero: a float32 significand aligned to a number whose
    ``frexp`` exponent is ``exponent``."""
    quantum = torch.ldexp(torch.ones_like(v), exponent - 24)
    return torch.trunc(v / quantum) * quantum


def _in_tensor_core_order(group):
    """The first layer's sums under ``fused_turn.bf16_band``'s model of
    the tensor cores: per step, ``group`` exact products (float64 holds
    them) and the float32 accumulator are aligned to the largest one's
    exponent and truncated to float32's 24 bits, summed exactly, and the
    sum is truncated to float32."""
    def first_layer(x, w0f):
        x, w0f = x.double(), w0f.double()
        acc = torch.zeros((x.shape[0], w0f.shape[1]), dtype=torch.float64)
        for k0 in range(0, x.shape[1], group):
            products = [x[:, k:k + 1] * w0f[k]
                        for k in range(k0, min(k0 + group, x.shape[1]))]
            top = acc.abs()
            for p in products:
                top = torch.maximum(top, p.abs())
            exponent = torch.frexp(top).exponent
            total = _truncated(acc, exponent)
            for p in products:
                total = total + _truncated(p, exponent)
            acc = _truncated(total, torch.frexp(total).exponent)
        assert torch.equal(acc, acc.float().double())
        return acc.float()
    return first_layer


def _kernel_order_turn(args, A, T, rounded=fused_turn_lib.ROUNDED,
                       first_layer=_in_index_order):
    """The bf16 variant's turn with its float32 sums in a kernel's order:
    the first layer's sums by ``first_layer`` from 0, then the bias; the
    second layer unit by unit.  ``rounded`` leaves an operand unrounded,
    as a faulty kernel would."""
    table, w0, b0, w1, b1, idx, g_act, g_ch = args
    din = 2 * A * A
    rows = table[idx.long()]
    obs = torch.cat([rows[:, :din], rows[:, din:2 * din]], 0)
    mask = torch.cat([rows[:, 2 * din:2 * din + A],
                      rows[:, 2 * din + A:2 * din + 2 * A]], 0)
    rnd = lambda v, name: v.bfloat16().float() if name in rounded else v
    x, w0f, w1f = rnd(obs, "row"), w0.float(), w1.float()
    h = rnd(torch.relu(first_layer(x, w0f) + b0), "hidden")
    out = torch.zeros((x.shape[0], A + 1))
    for u in range(h.shape[1]):
        out = out + h[:, u:u + 1] * w1f[u]
    out = out + b1
    ml = torch.where(mask > 0, out[:, :A], torch.full_like(mask, -1e30))
    return fused_turn_lib.turn_from_logits(table, rows, ml, mask, out[:, A],
                                           g_act, g_ch, A=A, T=T)


@pytest.fixture(scope="module", params=[3, 5], ids=["A=3", "A=5"])
def band_args(request):
    """A bf16 turn's arguments at width 256 on 2048 lanes of a tree."""
    A = request.param
    tree = torch_tree_lib.generate_tree(torch_config.TreeConfig(
        max_actions=A, max_transitions=2, transition_threshold=0.3,
        depth_bound=3), seed=0, device="cpu")
    gen = torch.Generator().manual_seed(A)
    w0, b0, w1, b1 = [w.detach().contiguous() for w in
                      torch_nets.mlp_fused_weights(torch_nets.MLP(
                          A, 256, generator=torch.Generator().manual_seed(A)))]
    idx = torch.randint(0, tree.size, (2048,), generator=gen,
                        dtype=torch.int32)
    g_act, g_ch = torch_engine.turn_noise(2048, A, 2, gen, "cpu")
    return A, [torch_stepping.make_packed_tables(tree).rows, w0.bfloat16(),
               b0, w1.bfloat16(), b1, idx, g_act, g_ch]


def test_bf16_check_takes_the_kernels_sum_order(band_args):
    A, args = band_args
    res = fused_turn_lib.check_bf16(_kernel_order_turn(args, A, 2), args,
                                    A=A, T=2)
    assert all(share > 0 for share in res["controls"].values())


@pytest.mark.parametrize("skipped", fused_turn_lib.ROUNDED)
def test_bf16_check_rejects_an_unrounded_operand(band_args, skipped):
    A, args = band_args
    kept = tuple(r for r in fused_turn_lib.ROUNDED if r != skipped)
    with pytest.raises(AssertionError, match="parts from its plain"):
        fused_turn_lib.check_bf16(_kernel_order_turn(args, A, 2, kept), args,
                                  A=A, T=2)


@pytest.mark.parametrize("products,model,nearest", [
    # aligned to 1, the 1.5 ulps of the second product lose their half
    ((1.0, 1.5 * 2.0 ** -23), 1 + 2.0 ** -23, 1 + 2.0 ** -22),
    # exact when aligned; the sum 2 + 1.5 ulps(2) is truncated
    ((1.75, 0.25 + 3 * 2.0 ** -23), 2 + 2.0 ** -22, 2 + 2.0 ** -21)])
def test_tensor_core_model_truncates(products, model, nearest):
    """The model's step on two products whose float32 sum must drop bits:
    it truncates where round to nearest (the index order's adds) rounds
    up."""
    x = torch.tensor([[1.0, 1.0]])
    w0 = torch.tensor([[products[0]], [products[1]]])
    for group in (1, 16):
        assert float(_in_tensor_core_order(group)(x, w0)) == model
    assert float(_in_index_order(x, w0)) == nearest


@pytest.mark.parametrize("group", [4, 8, 16])
def test_bf16_check_takes_the_tensor_core_order(band_args, group):
    A, args = band_args
    res = fused_turn_lib.check_bf16(
        _kernel_order_turn(args, A, 2,
                           first_layer=_in_tensor_core_order(group)),
        args, A=A, T=2)
    assert all(share > 0 for share in res["controls"].values())


@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("skipped", fused_turn_lib.ROUNDED)
def test_bf16_check_rejects_an_unrounded_operand_in_the_tensor_core_order(
        band_args, skipped, group):
    A, args = band_args
    kept = tuple(r for r in fused_turn_lib.ROUNDED if r != skipped)
    with pytest.raises(AssertionError, match="parts from its plain"):
        fused_turn_lib.check_bf16(
            _kernel_order_turn(args, A, 2, kept,
                               first_layer=_in_tensor_core_order(group)),
            args, A=A, T=2)
