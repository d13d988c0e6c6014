"""The port's two kernels: plain versions against the TPU kernels (run in
interpret mode on the CPU), wrapper dispatch and argument checks.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are those of tests/test_pallas_turn.py: episodes (indices,
actions, rewards) equal, policy and values within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.config import NetConfig
from rnad_tpu.models import nets as jax_nets
from rnad_tpu.ops import pallas_lookup, pallas_turn
from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import _build
from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
from rnad_tpu_torch.ops import lookup as lookup_lib
from tests.torch_parity import torch_mlp

A, T, WIDTH, B = 3, 2, 32, 256


@pytest.fixture(scope="module")
def turn_inputs(small_tree):
    packed = jax_stepping.make_packed_tables(small_tree)
    net = jax_nets.build_net(NetConfig(type="MLP", max_actions=A,
                                       width=WIDTH))
    variables = jax_nets.init_variables(net, jax.random.PRNGKey(0), A)
    rng = np.random.default_rng(5)
    indices = rng.integers(0, small_tree.size, B).astype(np.int32)
    k_act, k_ch = jax.random.split(jax.random.PRNGKey(7))
    g_act = np.array(jax.random.gumbel(k_act, (2 * B, A), jnp.float32))
    g_ch = np.array(jax.random.gumbel(k_ch, (T, B), jnp.float32).T)
    return packed, variables, indices, g_act, g_ch


def _torch_turn_args(packed, variables, indices, g_act, g_ch):
    tnet = torch_mlp(variables["params"], A, WIDTH)
    weights = [w.detach().contiguous()
               for w in torch_nets.mlp_fused_weights(tnet)]
    return (torch.from_numpy(np.array(packed.rows)), *weights,
            torch.from_numpy(indices), torch.from_numpy(g_act),
            torch.from_numpy(np.ascontiguousarray(g_ch)))


@pytest.mark.parametrize("source", ["random", "packed"])
def test_lookup_plain_bitwise_vs_pallas(source, small_tree):
    rng = np.random.default_rng(0)
    if source == "random":
        table = rng.normal(size=(160, 128)).astype(np.float32)
    else:
        table = np.array(jax_stepping.make_packed_tables(small_tree).rows)
    idx = rng.integers(0, table.shape[0], 1024).astype(np.int32)
    want = pallas_lookup.onehot_lookup(jnp.asarray(table), jnp.asarray(idx),
                                       interpret=True)
    got = lookup_lib.lookup_plain(torch.from_numpy(table),
                                  torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_turn_plain_vs_pallas(turn_inputs):
    packed, variables, indices, g_act, g_ch = turn_inputs
    want = pallas_turn.fused_turn(
        packed.rows, *pallas_turn.mlp_fused_weights(variables["params"], A),
        jnp.asarray(indices), jnp.asarray(g_act), jnp.asarray(g_ch), A=A, T=T,
        interpret=True, tile=128)
    got = fused_turn_lib.fused_turn_plain(
        *_torch_turn_args(packed, variables, indices, g_act, g_ch), A=A, T=T)
    names = ("new_idx", "policy", "actions", "rewards", "values")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("policy", "values"):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


def test_wrappers_take_plain_version_on_cpu(turn_inputs):
    packed, variables, indices, g_act, g_ch = turn_inputs
    args = _torch_turn_args(packed, variables, indices, g_act, g_ch)
    before = (fused_turn_lib.fused_turn.launches, lookup_lib.lookup.launches)
    got = fused_turn_lib.fused_turn(*args, A=A, T=T)
    plain = fused_turn_lib.fused_turn_plain(*args, A=A, T=T)
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    rows = lookup_lib.lookup(args[0], args[5])
    torch.testing.assert_close(rows, lookup_lib.lookup_plain(args[0], args[5]),
                               rtol=0, atol=0)
    # CPU calls launch nothing
    assert (fused_turn_lib.fused_turn.launches,
            lookup_lib.lookup.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take(turn_inputs):
    packed, variables, indices, g_act, g_ch = turn_inputs
    args = list(_torch_turn_args(packed, variables, indices, g_act, g_ch))
    table, idx = args[0], args[5]
    with pytest.raises(TypeError):
        lookup_lib.lookup(table, idx.long())
    with pytest.raises(TypeError):
        lookup_lib.lookup(table.double(), idx)
    with pytest.raises(ValueError):
        lookup_lib.lookup(table[:, :126], idx)
    with pytest.raises(ValueError):
        lookup_lib.lookup(table.t(), idx)
    bad = list(args)
    bad[6] = args[6][:, :2].contiguous()  # g_act of the wrong width
    with pytest.raises(ValueError, match="g_act"):
        fused_turn_lib.fused_turn(*bad, A=A, T=T)
    bad = list(args)
    bad[5] = args[5].long()
    with pytest.raises(TypeError, match="indices"):
        fused_turn_lib.fused_turn(*bad, A=A, T=T)
    with pytest.raises(ValueError, match="A <= 8"):  # A = 9
        fused_turn_lib.fused_turn(
            torch.zeros((4, 1024)), torch.zeros((162, 8)), torch.zeros(8),
            torch.zeros((8, 10)), torch.zeros(10),
            torch.zeros(4, dtype=torch.int32), torch.zeros((8, 9)),
            torch.zeros((4, T)), A=9, T=T)


@pytest.mark.parametrize("A,W", [(3, 256), (5, 384), (8, 128)])
def test_fused_turn_operation_count(A, W):
    """The count K1's bound uses: an FMA (two operations) for each W0 entry
    and each entry of the fused W1 that is not a block-diagonal zero."""
    net = torch_nets.MLP(A, W, generator=torch.Generator().manual_seed(0))
    w0, _, w1, _ = torch_nets.mlp_fused_weights(net)
    assert fused_turn_lib.operations(A, 2 * W) == 2 * (
        w0.numel() + int((w1 != 0).sum()))
    assert fused_turn_lib.operations(3, 512) == 2 * 10240


@pytest.mark.parametrize("symbol,name", [
    # the fused turn's kernels sit in an anonymous namespace, whose name
    # ends in digits that run into the kernel name's length
    ("_ZN46_GLOBAL__N__678c4e65_13_fused_turn_cu_43c6a85617fused_turn_"
     "kernelILi3EEEvPKfiiPKiS2_S2_S2_S2_S2_S2_PiPfS5_S6_S6_iii",
     "fused_turn_kernel<3>"),
    ("_ZN46_GLOBAL__N__678c4e65_13_fused_turn_cu_43c6a85622fused_turn_"
     "bf16_kernelILi5EEEvPKfiiPKiPK13__nv_bfloat16S2_S7_S2_S2_S2_PiPfS8_"
     "S9_S9_iii", "fused_turn_bf16_kernel<5>"),
    ("_Z13rmplus_kernelILi5EEvPKfS1_Pfiiii", "rmplus_kernel<5>"),
    ("_Z13lookup_kernelPKfPKiPfiii", "lookup_kernel")])
def test_ptxas_lines_name_the_kernels(symbol, name):
    """``kernel_bench.py`` and ``chip_smoke.py`` read each kernel's
    registers and spills from nvcc's log by these names."""
    log = (f"ptxas info    : Compiling entry function '{symbol}' for "
           f"'sm_90a'\nptxas info    : Used 122 registers, used 1 barriers\n")
    assert _build.ptxas_lines(log) == [
        (name, "ptxas info    : Used 122 registers, used 1 barriers")]
