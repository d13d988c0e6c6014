"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without an NVIDIA
card.  This file imports nothing of JAX, so on the card it runs without the
repository's conftest (which starts JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the packed-row lookup (K2) is bit-exact.  The fused turn (K1)
sums its dot products in another order than cuBLAS, so policy and values
agree within atol 1e-5, and an action may differ from the plain version's
only where its two best Gumbel scores lie within 1e-5 of each other (a
near-tie); the transition of a lane whose actions agree is equal.  The RM+
solver (K3) is held to its plain version by ``solver_device.agreement``:
x, y and v within atol 1e-5 except on a counted share of games where
float32 rounding in another order parted the two runs, which as a set are
as good as the plain version's (mean and worst exploitability).  The
EquiNet's frozen passes (K4) keep the eager bf16 forward's rounding points
and sum each product in the tensor cores' order, so an output parts from
the eager one only where a sum lies near a bf16 rounding tie: on a bounded
share of elements, by a bounded number of bf16 units in the last place.
The trainable net's backward (K5) keeps eager autograd's bf16 rounding
points but sums the weight gradients' float32 terms in its own order, so
each leaf's gradient lies within a bounded gap of autograd's, relative to
the leaf's largest element.
"""

import copy
import ctypes
import dataclasses

import pytest
import torch

from rnad_tpu_torch import equinet_probe
from rnad_tpu_torch.config import (NetConfig, RNaDConfig, ShapingRule,
                                   TreeConfig)
from rnad_tpu_torch.env import engine, solver_device
from rnad_tpu_torch.env import tree as tree_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import _build
from rnad_tpu_torch.ops import equinet as equinet_lib
from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
from rnad_tpu_torch.ops import lookup as lookup_lib
from rnad_tpu_torch.ops import rmplus as rmplus_lib
from rnad_tpu_torch.ops import stepping

NEAR_TIE = 1e-5
# the share of an A = 5 tree's rows whose solver features (with log x) may
# part between the card and the CPU; measured 0.0366 on the H100
FEATURES_PARTED_SHARE = 0.05


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _tree(dev, A=3, T=2, depth=3, seed=0):
    cfg = TreeConfig(max_actions=A, max_transitions=T,
                     transition_threshold=0.3, depth_bound=depth)
    return tree_lib.generate_tree(cfg, seed=seed, device=dev)


def _turn_args(dev, tree, width, B, seed):
    packed = stepping.make_packed_tables(tree)
    A, T = tree.max_actions, tree.max_transitions
    gen = torch.Generator(device=dev).manual_seed(seed)
    net = nets.MLP(A, width, generator=torch.Generator().manual_seed(seed))
    weights = [w.detach().contiguous()
               for w in nets.mlp_fused_weights(net.to(dev))]
    idx = torch.randint(0, tree.size, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    g_act, g_ch = engine.turn_noise(B, A, T, gen, dev)
    return [packed.rows, *weights, idx, g_act, g_ch]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1000, 131072])
def test_lookup_kernel_bitwise(dev, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    # random bit patterns, with the exponent's top bit cleared so that every
    # value is finite (denormals and negative zero included)
    bits = torch.randint(-2**31, 2**31 - 1, (4099, 128), generator=gen,
                         device=dev, dtype=torch.int32)
    table = (bits & ~(1 << 30)).view(torch.float32)
    idx = torch.randint(0, table.shape[0], (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    before = lookup_lib.lookup.launches
    got = lookup_lib.lookup(table, idx)
    want = lookup_lib.lookup_plain(table, idx)
    torch.cuda.synchronize()
    assert got.shape == (n, 128)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert lookup_lib.lookup.launches == before + (1 if n else 0)


@pytest.mark.cuda
def test_lookup_kernel_rejects(dev):
    table = torch.zeros((8, 128), device=dev)
    with pytest.raises(ValueError):
        lookup_lib.lookup(table, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        lookup_lib.lookup(table[:, :6], torch.zeros(4, dtype=torch.int32,
                                                    device=dev))


TILE = fused_turn_lib.TILE_LANES


@pytest.mark.cuda
@pytest.mark.parametrize("A,T,width,B", [
    (3, 2, 32, 256), (3, 2, 256, 4099), (4, 3, 64, 1000), (2, 1, 8, 33),
    # the MLP path's shape, and the ragged edges of a block's tile of lanes
    (3, 2, 256, 32768), (3, 2, 256, TILE - 1), (3, 2, 256, TILE),
    (3, 2, 256, TILE + 1), (8, 8, 16, 2 * TILE + 1),
    # the widest K1 holds at A = 8 and a wide one at A = 5
    (8, 8, 128, 1000), (5, 2, 384, 1000)])
def test_fused_turn_kernel_vs_plain(dev, A, T, width, B):
    tree = _tree(dev, A=A, T=T)
    args = _turn_args(dev, tree, width, B, seed=A * 100 + width)
    before = fused_turn_lib.fused_turn.launches
    got = fused_turn_lib.fused_turn(*args, A=A, T=T)
    torch.cuda.synchronize()
    assert fused_turn_lib.fused_turn.launches == before + 1
    want = fused_turn_lib.fused_turn_plain(*args, A=A, T=T)
    _, ml, _, _ = fused_turn_lib.turn_logits_plain(*args[:6], A=A)
    top2 = (ml + args[6]).topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1] < NEAR_TIE).reshape(2, B).any(0)
    new_g, pol_g, act_g, rew_g, val_g = got
    new_w, pol_w, act_w, rew_w, val_w = want
    flipped = (act_g != act_w).any(0)
    assert not (flipped & ~near).any()
    agree = ~flipped
    assert torch.equal(new_g[agree], new_w[agree])
    assert torch.equal(rew_g[agree], rew_w[agree])
    torch.testing.assert_close(pol_g, pol_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(val_g, val_w, rtol=0, atol=1e-5)
    assert ((pol_g.sum(-1) - 1).abs() < 1e-5).all()


@pytest.mark.cuda
def test_fused_turn_kernel_is_deterministic(dev):
    """Two launches on the same inputs are bitwise equal: the second layer's
    partials are reduced in a fixed order, with no atomics."""
    tree = _tree(dev)
    args = _turn_args(dev, tree, 256, 32768, seed=5)
    first = fused_turn_lib.fused_turn(*args, A=3, T=2)
    second = fused_turn_lib.fused_turn(*args, A=3, T=2)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_fused_turn_kernel_widths_in_any_order(dev):
    """Wide, then a width no other test takes, then wide again at the same
    A in one process: the shared-memory attribute belongs to the kernel of
    that A, and a narrow launch must not leave it too small for a wide
    one."""
    tree = _tree(dev)
    for width in (256, 40, 256):
        args = _turn_args(dev, tree, width, 1000, seed=width)
        got = fused_turn_lib.fused_turn(*args, A=3, T=2)
        want = fused_turn_lib.fused_turn_plain(*args, A=3, T=2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_mlp_too_wide_for_k1_takes_the_generic_turn(dev):
    """"auto" rolls an MLP whose weights K1 cannot hold in shared memory
    out through the generic turn (K2 and the net's own forward); "on"
    raises K1's error."""
    tree = _tree(dev, A=8, T=2)
    packed = stepping.make_packed_tables(tree)
    net = nets.MLP(8, 192, generator=torch.Generator().manual_seed(0))
    net = net.to(dev)
    assert fused_turn_lib.fits(8, 256) and not fused_turn_lib.fits(8, 384)
    assert not engine.uses_fused_turn(net, "auto")
    init = torch.ones((512,), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = fused_turn_lib.fused_turn.launches
    traj = engine.rollout_from(tree, packed, net, init, generator=gen)
    assert fused_turn_lib.fused_turn.launches == before
    assert torch.isfinite(traj.values).all()
    with pytest.raises(ValueError, match="shared memory"):
        engine.rollout_from(tree, packed, net, init, generator=gen,
                            rows_actor="on")


@pytest.mark.cuda
def test_fused_turn_kernel_rejects(dev):
    tree = _tree(dev)
    args = _turn_args(dev, tree, 32, 64, seed=0)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="indices"):
        fused_turn_lib.fused_turn(*bad, A=3, T=2)
    # weights too wide for shared memory
    wide = nets.MLP(3, 4096).to(dev)
    big = [w.detach().contiguous() for w in nets.mlp_fused_weights(wide)]
    with pytest.raises(ValueError, match="shared memory"):
        fused_turn_lib.fused_turn(args[0], *big, *args[5:], A=3, T=2)
    # the bf16 variant copies W0's rows and W1 in 4-byte words: an odd 2W
    # or a weight at an odd bf16 offset is refused
    w0, b0, w1, b1 = args[1:5]
    odd = [w0[:, :63].bfloat16().contiguous(), b0[:63].contiguous(),
           w1[:63].bfloat16().contiguous(), b1]
    with pytest.raises(ValueError, match="4-byte words"):
        fused_turn_lib.fused_turn(args[0], *odd, *args[5:], A=3, T=2)
    shifted = torch.zeros(w0.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted[1:] = w0.reshape(-1).bfloat16()
    with pytest.raises(ValueError, match="4-byte words"):
        fused_turn_lib.fused_turn(args[0], shifted[1:].view(w0.shape), b0,
                                  w1.bfloat16(), b1, *args[5:], A=3, T=2)


def _random_games(dev, B, R, C, seed):
    """Random payoffs in [-1, 1) with random illegal rows and columns (at
    least one legal action a seat), illegal cells zeroed, batch-minor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    M = torch.rand((B, R, C), generator=gen, device=dev) * 2 - 1
    lr = (torch.rand((B, R), generator=gen, device=dev) > 0.2).float()
    lc = (torch.rand((B, C), generator=gen, device=dev) > 0.2).float()
    lr[:, 0] = 1.0
    lc[:, 0] = 1.0
    M = M * lr[:, :, None] * lc[:, None, :]
    return M, lr, lc


def _check_rmplus(M, lr, lc, iters):
    """K3 against its plain version with the criterion of
    ``solver_device.agreement``.  Returns the count of diverged games."""
    Mm = M.permute(1, 2, 0).contiguous()
    lrm, lcm = lr.t().contiguous(), lc.t().contiguous()
    before = rmplus_lib.rmplus.launches
    got = rmplus_lib.rmplus(Mm, lrm, lcm, iters)
    torch.cuda.synchronize()
    assert rmplus_lib.rmplus.launches == before + (1 if M.shape[0] else 0)
    want = rmplus_lib.rmplus_plain(Mm, lrm, lcm, iters)
    result = solver_device.agreement(M, lr, lc, [t.t() for t in got[:2]],
                                     [t.t() for t in want[:2]], got[2],
                                     want[2])
    assert result.ok, result
    return result.diverged


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,C", [(0, 5, 5), (1, 5, 5), (65537, 5, 5),
                                   (4099, 3, 7), (1000, 16, 16),
                                   (333, 1, 2)])
def test_rmplus_kernel_vs_plain(dev, B, R, C):
    M, lr, lc = _random_games(dev, B, R, C, seed=B + R)
    _check_rmplus(M, lr, lc, 128)


@pytest.mark.cuda
def test_rmplus_kernel_at_learner_size(dev):
    """T * B = 327,680 observed games of the A = 5 EquiNet learner."""
    M, lr, lc = _random_games(dev, 327680, 5, 5, seed=7)
    _check_rmplus(M, lr, lc, 128)


@pytest.mark.cuda
def test_rmplus_kernel_on_observed_tree_games(dev):
    """Both seats' observed games at 32768 random states of the EquiNet
    path's A = 5 tree (65,536 games, one rollout turn's solve)."""
    cfg = TreeConfig(max_actions=5, max_transitions=2,
                     transition_threshold=0.25, depth_bound=5,
                     depth_bound_rule=ShapingRule(-1, -2, 0.55))
    tree = tree_lib.generate_tree(cfg, seed=0, device=dev)
    packed = stepping.make_packed_tables(tree)
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(1, tree.size, (32768,), generator=gen, device=dev,
                        dtype=torch.int32)
    obs = torch.cat(stepping.slice_observations(
        packed, stepping.lookup(packed, ids)))
    legal = obs[:, 1]
    lr, lc = legal.amax(2), legal.amax(1)
    assert obs.shape[0] == 65536
    _check_rmplus(obs[:, 0] * lr[:, :, None] * lc[:, None, :], lr, lc, 128)


@pytest.mark.cuda
def test_rmplus_kernel_takes_any_mask(dev):
    """Masks with values between 0 and 1 on every third game, so warps mix
    games of both kinds: the kernel keeps the products by the mask there
    and agrees with the plain version.  RM+ does not converge under such
    masks and two float32 orders part on more games the longer it runs,
    so the check runs 16 iterations
    (tests/test_torch_rmplus.py::test_plain_handles_masks_other_than_zero_one)."""
    M, lr, lc = _random_games(dev, 65536, 5, 5, seed=13)
    gen = torch.Generator(device=dev).manual_seed(14)
    soft = torch.arange(65536, device=dev) % 3 == 0
    scale = lambda m: torch.where(
        soft[:, None], m * (0.25 + 0.75 * torch.rand(m.shape, generator=gen,
                                                     device=dev)), m)
    _check_rmplus(M, scale(lr), scale(lc), 16)


@pytest.mark.cuda
def test_rmplus_kernel_is_deterministic(dev):
    M, lr, lc = _random_games(dev, 65536, 5, 5, seed=11)
    args = (M.permute(1, 2, 0).contiguous(), lr.t().contiguous(),
            lc.t().contiguous(), 128)
    first = rmplus_lib.rmplus(*args)
    second = rmplus_lib.rmplus(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_rmplus_kernel_rejects(dev):
    M = torch.zeros((17, 5, 8), device=dev)
    with pytest.raises(ValueError, match="MAX_ACTIONS"):
        rmplus_lib.rmplus(M, torch.zeros((17, 8), device=dev),
                          torch.zeros((5, 8), device=dev), 4)
    with pytest.raises(ValueError, match="lr"):
        rmplus_lib.rmplus(M[:5].contiguous(), torch.zeros((5, 8)),
                          torch.zeros((5, 8), device=dev), 4)


@pytest.mark.cuda
def test_train_step_card_vs_cpu(dev):
    """One fused train step through both kernels on the card and through
    the plain versions on the CPU, from the same weights and noise: equal
    episodes, losses within rtol 1e-5, new weights within 1e-5 (a hundredth
    of lr, the most Adam with b1=0 moves a weight)."""
    tree = _tree("cpu", depth=4)
    cfg = RNaDConfig(batch_size=512, eta=0.2, lr=1e-3, logit_clip=2.0)
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(512, 3, 2, gen, "cpu")
             for _ in range(tree.max_depth)]
    out = {}
    for device in ("cpu", dev):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(NetConfig(max_actions=3, width=64),
                             torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        k1, k2 = fused_turn_lib.fused_turn.launches, lookup_lib.lookup.launches
        traj = rnad.rollout(state, dtree, packed, cfg, noise)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        launched = (fused_turn_lib.fused_turn.launches - k1,
                    lookup_lib.lookup.launches - k2)
        # the learner reads the observations K1 stored: no regather
        assert launched == ((tree.max_depth, 0) if device == dev else (0, 0))
        out[str(device)] = (traj, metrics, [p.detach().cpu()
                                            for p in state.net.parameters()])
    (tc, mc, pc), (tg, mg, pg) = out["cpu"], out[str(dev)]
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(tc, f), getattr(tg, f).cpu()), f
    for k in ("loss", "loss_v", "loss_nerd"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-7)
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


EQUI = NetConfig(type="EquiNet", max_actions=3, channels=16, depth=2,
                 solver_iters=32, solver_prime=True)


@pytest.mark.cuda
def test_equinet_train_step_card_vs_cpu(dev):
    """One EquiNet train step on the card (K2 and K3, the generic turn) and
    on the CPU from the same weights and noise: per step max_depth + 1
    launches of K2 and K3 and none of K1; at most 2 % of the episodes part
    (where a float32 RM+ difference flips a near-tied action); new weights
    within 2 lr (Adam with b1=0 moves a weight at most lr either way)."""
    tree = _tree("cpu", depth=4)
    cfg = RNaDConfig(batch_size=512, eta=0.2, lr=1e-3, logit_clip=2.0)
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(512, 3, 2, gen, "cpu")
             for _ in range(tree.max_depth)]
    out = {}
    for device in ("cpu", dev):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(EQUI, torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        before = (fused_turn_lib.fused_turn.launches,
                  lookup_lib.lookup.launches, rmplus_lib.rmplus.launches)
        traj = rnad.rollout(state, dtree, packed, cfg, noise)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        launched = (fused_turn_lib.fused_turn.launches - before[0],
                    lookup_lib.lookup.launches - before[1],
                    rmplus_lib.rmplus.launches - before[2])
        md = tree.max_depth
        # K2 a turn; the learner solves the stored observations (K3)
        assert launched == ((0, md, md + 1) if device == dev
                            else (0, 0, 0))
        assert torch.isfinite(metrics["loss"]).all()
        out[str(device)] = (traj, [p.detach().cpu()
                                   for p in state.net.parameters()])
    (tc, pc), (tg, pg) = out["cpu"], out[str(dev)]
    parted = (tc.actions != tg.actions.cpu()).any(0)
    assert parted.float().mean() <= 0.02
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(tc, f)[:, ~parted],
                           getattr(tg, f).cpu()[:, ~parted]), f
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=2 * cfg.lr)


@pytest.mark.cuda
def test_equinet_rnad_runs_on_the_card(dev, tmp_path):
    tree = _tree("cpu")
    cfg = RNaDConfig(batch_size=1024, bounds=(2,), delta_m=(3,), lr=1e-3,
                     nashconv_chunk_nodes=40)
    run = rnad.RNaD(tree, cfg, EQUI, runs_root=str(tmp_path))
    k = (fused_turn_lib.fused_turn.launches, lookup_lib.lookup.launches,
         rmplus_lib.rmplus.launches)
    run.run(log_mod=1)
    value = run.final_eval()
    md, chunks = tree.max_depth, -(-tree.size // 40)
    assert (fused_turn_lib.fused_turn.launches - k[0],
            lookup_lib.lookup.launches - k[1],
            rmplus_lib.rmplus.launches - k[2]) == (
                0, 6 * md, 6 * (md + 1) + 2 * chunks)
    assert all(torch.isfinite(torch.tensor(v))
               for _, m in run.history for v in m.values())
    assert 0.0 <= value < 10.0


@pytest.mark.cuda
def test_rnad_runs_on_the_card(dev, tmp_path):
    tree = _tree("cpu")
    cfg = RNaDConfig(batch_size=1024, bounds=(2,), delta_m=(3,), lr=1e-3)
    run = rnad.RNaD(tree, cfg, NetConfig(max_actions=3, width=64),
                    runs_root=str(tmp_path))
    assert run.device.type == "cuda"
    k1, k2 = fused_turn_lib.fused_turn.launches, lookup_lib.lookup.launches
    run.run(log_mod=1)
    value = run.final_eval()
    assert fused_turn_lib.fused_turn.launches - k1 == 6 * tree.max_depth
    assert lookup_lib.lookup.launches - k2 == 0  # the stored observations
    assert all(torch.isfinite(torch.tensor(v))
               for _, m in run.history for v in m.values())
    assert 0.0 <= value < 10.0
    small = dataclasses.replace(cfg, batch_size=64)
    traj = rnad.rollout(run.state, run.tree, run.packed, small)
    assert traj.indices.is_cuda and engine.episode_returns(traj).abs().max() <= 1


@pytest.mark.cuda
def test_bf16_equinet_train_step_card_vs_cpu(dev):
    """One bfloat16 EquiNet train step at 256 lanes on the card and on the
    CPU from the same weights and noise: at most 2 % of the episodes part
    (near-ties), the others equal, new weights within 2 lr."""
    tree = _tree("cpu", depth=4)
    net_cfg = dataclasses.replace(EQUI, compute_dtype="bfloat16")
    cfg = RNaDConfig(batch_size=256, eta=0.5, lr=5e-5, logit_clip=2.0,
                     lr_schedule="cosine", lr_decay_steps=15,
                     lr_final_fraction=0.1)
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(256, 3, 2, gen, "cpu")
             for _ in range(tree.max_depth)]
    out = {}
    for device in ("cpu", dev):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        traj = rnad.rollout(state, dtree, packed, cfg, noise)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        assert torch.isfinite(metrics["loss"]).all()
        out[str(device)] = (traj, [p.detach().cpu()
                                   for p in state.net.parameters()])
    (tc, pc), (tg, pg) = out["cpu"], out[str(dev)]
    parted = (tc.actions != tg.actions.cpu()).any(0)
    assert parted.float().mean() <= 0.02
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(tc, f)[:, ~parted],
                           getattr(tg, f).cpu()[:, ~parted]), f
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=2 * cfg.lr)


@pytest.mark.cuda
@pytest.mark.parametrize("net_cfg", [
    NetConfig(max_actions=3, width=64),
    dataclasses.replace(EQUI, compute_dtype="bfloat16")])
def test_resume_on_the_card_is_bit_exact(dev, tmp_path, net_cfg):
    """A run resumed from checkpoint (0, 2) on the card ends on the weights
    and generator state of the run that went straight through."""
    tree = _tree("cpu")
    cfg = RNaDConfig(batch_size=1024, bounds=(2,), delta_m=(3,), lr=1e-3,
                     nashconv_chunk_nodes=40)
    make = lambda name: rnad.RNaD(tree, cfg, net_cfg, directory_name=name,
                                  runs_root=str(tmp_path))
    straight = make("straight")
    straight.run(checkpoint_mod=1)
    cut = make("cut")
    cut.run(max_updates=1, checkpoint_mod=1)  # 3 steps; latest is (0, 2)
    assert cut.store.latest() == (0, 2)
    resumed = make("cut")
    resumed.run(checkpoint_mod=1)
    assert resumed.state.total_steps == straight.state.total_steps == 6
    for name in ("net", "net_target", "net_reg", "net_reg_"):
        for p, q in zip(getattr(resumed.state, name).parameters(),
                        getattr(straight.state, name).parameters()):
            assert torch.equal(p, q), name
    assert torch.equal(resumed.state.generator.get_state(),
                       straight.state.generator.get_state())


BUFFERED = dict(n_batches_per_buffer=4, buffer_mod=2)
LIFT = dict(kind="lift", channels=8, sigma=0.15)
CONV = NetConfig(type="ConvNet", max_actions=3, channels=16, depth=2)


@pytest.mark.cuda
def test_buffered_learner_step_card_vs_cpu(dev):
    """Three rollouts through K1 on the card and the plain versions on the
    CPU from the same weights and noise (equal episodes), the same slots and
    lanes, then one learner step on the collated batch (one K2 launch):
    losses within rtol 1e-5, new weights within 1e-5."""
    import numpy as np

    from rnad_tpu_torch.learn import buffer as buffer_lib

    tree = _tree("cpu", depth=4)
    cfg = RNaDConfig(batch_size=256, eta=0.2, lr=1e-3, logit_clip=2.0,
                     **BUFFERED)
    gen = torch.Generator().manual_seed(3)
    md = tree.max_depth
    noise = [[engine.turn_noise(256, 3, 2, gen, "cpu") for _ in range(md)]
             for _ in range(3)]
    out = {}
    for device in ("cpu", dev):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(NetConfig(max_actions=3, width=64),
                             torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        buf = buffer_lib.TrajectoryBuffer(4)
        k1 = fused_turn_lib.fused_turn.launches
        for slot_noise in noise:
            buf.append(rnad.rollout(state, dtree, packed, cfg, slot_noise))
        slots, lanes = buf.plan(256, np.random.default_rng(7))
        assert all(x.device == torch.device(device) for x in lanes)
        k2 = lookup_lib.lookup.launches
        metrics = rnad.learn_step(state, packed,
                                  buffer_lib.collate_slots(slots, lanes),
                                  0.5, cfg)
        launched = (fused_turn_lib.fused_turn.launches - k1,
                    lookup_lib.lookup.launches - k2)
        # the slots hold the stored observations: no regather
        assert launched == ((3 * md, 0) if device == dev else (0, 0))
        out[str(device)] = (slots, metrics, [p.detach().cpu()
                                             for p in state.net.parameters()])
    (sc, mc, pc), (sg, mg, pg) = out["cpu"], out[str(dev)]
    for a, b in zip(sc, sg, strict=True):
        for f in ("indices", "actions", "rewards"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    for k in ("loss", "loss_v", "loss_nerd"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-7)
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("net_cfg", [CONV, NetConfig(max_actions=3,
                                                     width=64)])
def test_lift_train_step_card_vs_cpu(dev, net_cfg):
    """One train step under the lift (the generic turn: one K2 launch a
    turn, none in the learner, which reads the stored observations) on the
    card and on the CPU from the same weights and noise: equal episodes,
    stored observations within 1e-5, losses within rtol 1e-5, new weights,
    BatchNorm statistics and the EMA target within 1e-5."""
    from rnad_tpu_torch.config import ObsTransformConfig
    from rnad_tpu_torch.ops import obs_transform as obs_transform_lib

    tree = _tree("cpu", depth=4)
    cfg = RNaDConfig(batch_size=512, eta=0.2, lr=1e-3, logit_clip=2.0,
                     gamma_averaging=0.01,
                     obs_transform=ObsTransformConfig(**LIFT))
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(512, 3, 2, gen, "cpu", LIFT["channels"])
             for _ in range(tree.max_depth)]
    out = {}
    for device in ("cpu", dev):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        tf = rnad.resolve_obs_transform(net_cfg, dtree, cfg)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4),
                             obs_transform_lib.out_channels(cfg.obs_transform))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        k = (fused_turn_lib.fused_turn.launches, lookup_lib.lookup.launches)
        traj = rnad.rollout(state, dtree, packed, cfg, noise, tf)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        launched = (fused_turn_lib.fused_turn.launches - k[0],
                    lookup_lib.lookup.launches - k[1])
        assert launched == ((0, tree.max_depth) if device == dev else (0, 0))
        out[str(device)] = (traj, metrics, [
            t.detach().cpu() for name in ("net", "net_target")
            for t in getattr(state, name).state_dict().values()])
    (tc, mc, pc), (tg, mg, pg) = out["cpu"], out[str(dev)]
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(tc, f), getattr(tg, f).cpu()), f
    assert tg.obs.shape == (2 * tree.max_depth, 512, 9, 3, 3)
    torch.testing.assert_close(tg.obs.cpu(), tc.obs, rtol=0, atol=1e-5)
    for k in ("loss", "loss_v", "loss_nerd"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=1e-7)
    for a, b in zip(pc, pg, strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_convnet_lift_resume_on_the_card_is_bit_exact(dev, tmp_path):
    """A ConvNet run under the lift resumed from checkpoint (0, 2) on the
    card ends on the straight run's weights, BatchNorm statistics and
    generator state (cuDNN's deterministic algorithms)."""
    from rnad_tpu_torch.config import ObsTransformConfig

    tree = _tree("cpu")
    cfg = RNaDConfig(batch_size=512, bounds=(2,), delta_m=(3,), lr=1e-3,
                     obs_transform=ObsTransformConfig(**LIFT))
    make = lambda name: rnad.RNaD(tree, cfg, CONV, directory_name=name,
                                  runs_root=str(tmp_path))
    straight = make("straight")
    straight.run(checkpoint_mod=1)
    cut = make("cut")
    cut.run(max_updates=1, checkpoint_mod=1)  # 3 steps; latest is (0, 2)
    assert cut.store.latest() == (0, 2)
    resumed = make("cut")
    resumed.run(checkpoint_mod=1)
    assert resumed.state.total_steps == straight.state.total_steps == 6
    for name in ("net", "net_target", "net_reg", "net_reg_"):
        got = getattr(resumed.state, name).state_dict()
        want = getattr(straight.state, name).state_dict()
        assert any("bn" in k for k in want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert torch.equal(resumed.state.generator.get_state(),
                       straight.state.generator.get_state())


NEW_NETS = {
    "mlp_depth2_frozen_bf16": (
        NetConfig(type="MLP", max_actions=3, width=256, depth=2),
        "bfloat16"),
    "equinet_frozen_bf16": (EQUI, "bfloat16"),
    "convnet_bf16": (
        NetConfig(type="ConvNet", max_actions=3, channels=16, depth=2,
                  compute_dtype="bfloat16"), "float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_NETS))
def test_new_nets_step_card_vs_cpu(dev, name):
    """One step at 256 lanes of a depth-2 MLP and the EquiNet with
    bfloat16 frozen passes and of a bfloat16 ConvNet, on the card and on
    the CPU from the same weights and noise: at most 2 % of the episodes
    part (near-ties), the others equal.  Then one learner step on the
    card's trajectory on both: losses within rtol 1e-3 for the bfloat16
    frozen passes and 1e-2 for the bfloat16 ConvNet (a bfloat16 pass
    rounds float32 sums, which the devices take in another order, to
    2**-8; the ConvNet rounds at every layer and measured 1.5e-3), new
    weights and statistics within 2 lr plus the float32 rounding of the
    updated weights (1e-6)."""
    net_cfg, frozen = NEW_NETS[name]
    tree = _tree("cpu", depth=4)
    cfg = RNaDConfig(batch_size=256, eta=0.2, lr=5e-5, logit_clip=2.0,
                     frozen_net_dtype=frozen)
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(256, 3, 2, gen, "cpu")
             for _ in range(tree.max_depth)]
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
    states, packs, trajs = {}, {}, {}
    for device in ("cpu", dev):
        key = str(device)
        states[key] = rnad.init_train_state(copy.deepcopy(net).to(device),
                                            torch.Generator(device=device))
        packs[key] = stepping.make_packed_tables(tree.to(device))
        trajs[key] = rnad.rollout(states[key], tree.to(device), packs[key],
                                  cfg, noise)
    tc, tg = trajs["cpu"], trajs[str(dev)]
    parted = (tc.actions != tg.actions.cpu()).any(0)
    assert parted.float().mean() <= 0.02
    for f in ("indices", "actions", "rewards"):
        assert torch.equal(getattr(tc, f)[:, ~parted],
                           getattr(tg, f).cpu()[:, ~parted]), f
    shared = engine.Trajectory(*(None if t is None else t.cpu() for t in (
        tg.indices, tg.policy, tg.actions, tg.rewards, tg.values, tg.obs)))
    mg = rnad.learn_step(states[str(dev)], packs[str(dev)], tg, 0.5, cfg)
    mc = rnad.learn_step(states["cpu"], packs["cpu"], shared, 0.5, cfg)
    rtol = 1e-2 if net_cfg.compute_dtype == "bfloat16" else 1e-3
    for k in ("loss", "loss_v", "loss_nerd"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=rtol, atol=1e-6)
    for name_ in ("net", "net_target"):
        got = getattr(states[str(dev)], name_).state_dict()
        want = getattr(states["cpu"], name_).state_dict()
        for k in want:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0,
                                       atol=2 * cfg.lr + 1e-6)


def _check_bf16_turn(args, A, T):
    """One launch of the bf16 variant, held to its plain version by
    ``fused_turn.check_bf16`` (chip_smoke.py holds it the same way):
    outputs within ``fused_turn.bf16_band``, actions differing only at
    near-ties of twice the row's band, and the two unrounded-operand
    controls outside the band."""
    before = fused_turn_lib.fused_turn.launches_bf16
    got = fused_turn_lib.fused_turn(*args, A=A, T=T)
    torch.cuda.synchronize()
    assert fused_turn_lib.fused_turn.launches_bf16 == before + 1
    fused_turn_lib.check_bf16(got, args, A=A, T=T)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("A,T,width,B", [
    (3, 2, 256, 32768), (5, 2, 256, 32768), (3, 2, 256, TILE + 1),
    (8, 8, 16, 2 * TILE + 1), (4, 3, 64, 1000),
    # wider than the float32 variant holds at A = 5
    (5, 2, 640, 1000)])
def test_bf16_fused_turn_kernel_vs_plain(dev, A, T, width, B):
    tree = _tree(dev, A=A, T=T)
    args = _turn_args(dev, tree, width, B, seed=A * 100 + width + 1)
    args[1] = args[1].bfloat16()
    args[3] = args[3].bfloat16()
    if width == 640:
        assert not fused_turn_lib.fits(A, 2 * width)
        assert fused_turn_lib.fits(A, 2 * width, torch.bfloat16)
    got = _check_bf16_turn(args, A, T)
    # the bf16 operands move the logits: not the float32 variant's values
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    _, ml16, mask, _ = fused_turn_lib.turn_logits_plain(*args[:6], A=A)
    _, ml32, _, _ = fused_turn_lib.turn_logits_plain(*f32[:6], A=A)
    assert float((ml16 - ml32).abs()[mask > 0].max()) > 1e-5
    assert torch.isfinite(got[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,T,width,B", [
    (3, 2, 256, 32768), (5, 2, 256, 32768), (3, 2, 256, TILE + 1),
    (8, 8, 16, 2 * TILE + 1), (4, 3, 64, 1)])
def test_fused_turn_stored_obs_vs_plain(dev, A, T, width, B, dtype):
    """K1's stored observations are bitwise the plain version's (the
    lanes' packed rows), and the launch with them gives the other outputs
    of the launch without them, bitwise."""
    tree = _tree(dev, A=A, T=T)
    args = _turn_args(dev, tree, width, B, seed=A * 100 + width + 2)
    args[1], args[3] = args[1].to(dtype), args[3].to(dtype)
    before = (fused_turn_lib.fused_turn.launches
              + fused_turn_lib.fused_turn.launches_bf16)
    got = fused_turn_lib.fused_turn(*args, A=A, T=T, store_obs=True)
    base = fused_turn_lib.fused_turn(*args, A=A, T=T)
    torch.cuda.synchronize()
    assert (fused_turn_lib.fused_turn.launches
            + fused_turn_lib.fused_turn.launches_bf16) == before + 2
    want = fused_turn_lib.fused_turn_plain(*args, A=A, T=T, store_obs=True)
    assert got[5].shape == (2, B, 2, A, A)
    assert torch.equal(got[5], want[5])
    for a, b in zip(got[:5], base):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [2, 4])
def test_k1_rollout_chunks_are_the_whole_rollout(dev, chunks):
    """On the same full-batch noise a chunked K1 rollout is bitwise the
    whole one, observations included."""
    tree = _tree(dev, depth=4)
    packed = stepping.make_packed_tables(tree)
    net = nets.MLP(3, 256, generator=torch.Generator().manual_seed(7)).to(
        dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    B = 4096
    noise = [engine.turn_noise(B, 3, 2, gen, dev)
             for _ in range(tree.max_depth)]
    init = torch.ones((B,), dtype=torch.int32, device=dev)
    roll = lambda **kw: engine.rollout_from(tree, packed, net, init,
                                            noise=noise, rows_actor="on",
                                            store_obs=True, **kw)
    whole, part = roll(), roll(lane_chunks=chunks)
    for f in ("indices", "policy", "actions", "rewards", "values", "obs"):
        assert torch.equal(getattr(part, f), getattr(whole, f)), f


@pytest.mark.cuda
def test_bf16_fused_turn_kernel_is_deterministic(dev):
    tree = _tree(dev)
    args = _turn_args(dev, tree, 256, 32768, seed=6)
    args[1], args[3] = args[1].bfloat16(), args[3].bfloat16()
    first = fused_turn_lib.fused_turn(*args, A=3, T=2)
    second = fused_turn_lib.fused_turn(*args, A=3, T=2)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_bf16_actor_too_wide_raises(dev):
    """No quiet float32: "auto" at a width the bf16 variant cannot hold
    raises, where the float32 actor takes the generic turn."""
    tree = _tree(dev, A=8, T=2)
    packed = stepping.make_packed_tables(tree)
    net = nets.MLP(8, 384, generator=torch.Generator().manual_seed(0)).to(dev)
    assert not fused_turn_lib.fits(8, 768, torch.bfloat16)
    assert not engine.uses_fused_turn(net, "auto")
    init = torch.ones((64,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16-operand variant"):
        engine.rollout_from(tree, packed, net, init,
                            actor_dtype=torch.bfloat16)


@pytest.mark.cuda
def test_bf16_actor_train_step_card_vs_cpu(dev):
    """One train step with ``rollout_actor_dtype="bfloat16"`` on the card
    (the bf16 K1, one launch a turn) and on the CPU (its plain version)
    from the same weights and noise, by chip_smoke.py's own check: at most
    2 % of the episodes part (near-ties of the bf16 band), the others
    equal; then one learner step on the card's trajectory on both: losses
    within rtol 1e-5, weights within 1e-5."""
    import chip_smoke

    cfg = RNaDConfig(batch_size=512, eta=0.2, lr=1e-3, logit_clip=2.0,
                     rollout_actor_dtype="bfloat16")
    chip_smoke.check_bf16_step_against_cpu(
        _tree("cpu", depth=4), cfg, NetConfig(max_actions=3, width=256),
        B=512)


@pytest.mark.cuda
def test_associative_learner_step_on_the_card(dev):
    """One learner step with ``vtrace_mode="associative"`` against the
    scan on the same trajectory on the card, within rnad_tpu's tolerances
    (tests/test_vtrace_assoc.py: losses rtol 2e-5, atol 2e-6; weights rtol
    1e-4, atol 1e-6)."""
    tree = _tree(dev, depth=4)
    packed = stepping.make_packed_tables(tree)
    net = nets.build_net(NetConfig(max_actions=3, width=64),
                         torch.Generator().manual_seed(7)).to(dev)
    cfg = RNaDConfig(batch_size=4096, eta=0.2, lr=1e-3, logit_clip=2.0)
    state = rnad.init_train_state(copy.deepcopy(net),
                                  torch.Generator(device=dev).manual_seed(1))
    traj = rnad.rollout(state, tree, packed, cfg)
    out = {}
    for mode in ("scan", "associative"):
        s = rnad.init_train_state(copy.deepcopy(net), torch.Generator(
            device=dev))
        m = rnad.learn_step(s, packed, traj, 0.5,
                            dataclasses.replace(cfg, vtrace_mode=mode))
        out[mode] = (m, [p.detach() for p in s.net.parameters()])
    (ms, ps), (ma, pa) = out["scan"], out["associative"]
    for k in ("loss", "loss_v", "loss_nerd"):
        torch.testing.assert_close(ma[k], ms[k], rtol=2e-5, atol=2e-6)
    for a, b in zip(pa, ps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_distillation_steps_card_vs_cpu(dev):
    """20 minibatched distillation steps of a depth-2 MLP on the card and
    on the CPU from the same weights and rows: final loss within rtol 1e-5,
    NashConv of the distilled nets within 1e-5, and no K3 launch."""
    from rnad_tpu_torch.learn import supervised

    tree = _tree("cpu", depth=4)
    gen = torch.Generator().manual_seed(0)
    idx = [torch.randint(0, 2 * tree.size, (256,), generator=gen)
           for _ in range(20)]
    net = nets.build_net(NetConfig(max_actions=3, width=64, depth=2),
                         torch.Generator().manual_seed(4))
    out = {}
    for device in ("cpu", dev):
        before = rmplus_lib.rmplus.launches
        _, out[str(device)] = supervised.train_oracle_net(
            tree.to(device), copy.deepcopy(net).to(device), steps=20,
            lr=3e-3, node_batch=256, batch_indices=idx, eval_chunk_nodes=64)
        assert rmplus_lib.rmplus.launches == before
    mc, mg = out["cpu"], out[str(dev)]
    assert abs(mg["final_loss"] - mc["final_loss"]) <= 1e-5 * abs(
        mc["final_loss"])
    assert abs(mg["nashconv"] - mc["nashconv"]) <= 1e-5


@pytest.mark.cuda
def test_equinet_distillation_step_card_vs_cpu(dev):
    """The primed solver EquiNet's distillation on the card (K3 in every
    forward) against the CPU (its plain version): on one minibatch at the
    same weights, the two devices' solves (x, y, v) of the rows' games
    part on at most ``DIVERGED_SHARE`` of them (float32 RM+ summed in
    another order), and each row's cross-entropy and squared value error
    agree within rtol 1e-5, atol 1e-6 wherever the two devices' solver
    features of the row's game agree within ``solver_device.ATOL`` (the
    features' log x magnifies a small difference of a probability near 0,
    and a primed net's logits are log x, so such a row's loss moves
    freely), and those features part on at most
    ``FEATURES_PARTED_SHARE`` of the rows.  Then one Adam step through
    ``train_oracle_net`` launches K3 once for the step and once for each
    eval chunk."""
    from rnad_tpu_torch.learn import supervised
    from rnad_tpu_torch.models import common

    tree = _tree("cpu", A=5, depth=3)
    net_cfg = NetConfig(type="EquiNet", max_actions=5, channels=8, depth=2,
                        solver_iters=128, solver_prime=True)
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
    obs, pol, val, weight = supervised.dataset(tree)
    rows = torch.randint(0, obs.shape[0], (4096,),
                         generator=torch.Generator().manual_seed(1))
    terms, solves = {}, {}
    for device in ("cpu", dev):
        o = obs[rows].reshape(-1, 2, 5, 5).to(device)
        with torch.no_grad():
            logits, value = copy.deepcopy(net).to(device)(o)
        log_pi = common.masked_log_policy(logits, o[:, 1, :, 0])
        ce = -(pol[rows].to(device) * log_pi).sum(-1)
        mse = (value - val[rows].to(device)) ** 2
        terms[str(device)] = torch.stack([ce, mse], -1).cpu()
        legal = o[:, 1]
        solves[str(device)] = [t.cpu() for t in (
            *solver_device.solve_zero_sum_rmplus(
                o[:, 0], legal.amax(2), legal.amax(1), iters=128),
            *nets._solver_features(o.permute(0, 2, 3, 1), 128))]

    def parted(pairs):
        err = torch.zeros(len(rows))
        for a, b in pairs:
            err = torch.maximum(err, (a - b).abs().reshape(len(rows), -1)
                                .amax(1))
        return err > solver_device.ATOL

    pairs = list(zip(solves["cpu"], solves[str(dev)]))
    assert parted(pairs[:3]).float().mean() <= solver_device.DIVERGED_SHARE
    agree = ~parted(pairs[3:])
    assert (~agree).float().mean() <= FEATURES_PARTED_SHARE
    torch.testing.assert_close(terms[str(dev)][agree], terms["cpu"][agree],
                               rtol=1e-5, atol=1e-6)
    before = rmplus_lib.rmplus.launches
    _, m = supervised.train_oracle_net(tree.to(dev),
                                       copy.deepcopy(net).to(dev), steps=1,
                                       node_batch=256, eval_chunk_nodes=64)
    assert rmplus_lib.rmplus.launches - before == 1 + -(-tree.size // 64)
    assert m["nashconv"] >= 0.0


@pytest.mark.cuda
def test_rollout_tabular_on_the_card(dev):
    """The oracle rollout of the stored solution on the card: the same
    episodes as on the CPU under the same noise, and a mean return within
    3 standard errors of the root value at 32768 lanes."""
    tree = _tree("cpu", depth=4)
    gen = torch.Generator().manual_seed(2)
    B = 32768
    noise = [engine.tabular_noise(B, 3, 2, gen, "cpu")
             for _ in range(tree.max_depth)]
    trajs = {str(d): engine.rollout_tabular(tree.to(d), tree.solution.to(d),
                                            B, noise=noise)
             for d in ("cpu", dev)}
    tc, tg = trajs["cpu"], trajs[str(dev)]
    for f in ("indices", "actions", "rewards", "values"):
        assert torch.equal(getattr(tc, f), getattr(tg, f).cpu()), f
    returns = engine.episode_returns(tg)
    se = float(returns.std()) / B ** 0.5
    assert abs(float(returns.mean()) - float(tree.root_value[1, 0])) < 3 * se


# K4 against the eager passes: the share of elements that part and the
# largest part in bf16 units in the last place (equinet_probe.differences)
K4_DIFFER_SHARE = 0.02
K4_MAX_ULPS = 4.0
K4_CASES = {  # (n, A, C, depth, solver_iters, primed, obs dtype)
    "flagship": (50000, 5, 64, 2, 32, True, torch.float32),
    "a3_unprimed_c0_2": (3001, 3, 16, 2, 0, False, torch.float32),
    "c128_depth4": (2000, 5, 128, 4, 16, True, torch.float32),
    "a8_ragged": (17, 8, 32, 1, 8, False, torch.float32),
    "one_observation": (1, 2, 48, 3, 8, True, torch.bfloat16),
    # the wide products' other k-step counts (C / 16 = 5, 6, 7)
    "c80_a4": (999, 4, 80, 1, 8, True, torch.float32),
    "c96_a6_depth2": (777, 6, 96, 2, 8, False, torch.float32),
    "c112_unprimed_c0_2": (500, 2, 112, 1, 0, False, torch.float32),
}


def _k4_inputs(dev, n, A, C, depth, iters, primed, obs_dtype, seed=3):
    frozen = equinet_probe.frozen_nets(A, C, depth, iters, primed, seed, dev)
    obs = equinet_probe.observations(n, A, seed + 1, dev)
    feats = nets.equinet_solver_features(frozen[0], obs) if iters else None
    return frozen, obs.to(obs_dtype), feats


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_equinet_frozen_kernel_vs_eager(dev, case):
    """Three frozen bf16 EquiNets in one K4 launch against their eager
    forwards, on observations with illegal actions (zero cells), at the
    flagship's shape, unprimed without solver features (c0 = 2), at
    rnad_tpu's default width and depth (weights staged a block at a time),
    with a ragged last tile, on one bf16 observation, and at C = 80, 96
    and 112 (each k-step count of the wide products)."""
    frozen, obs, feats = _k4_inputs(dev, *K4_CASES[case])
    want = equinet_lib.equinet_frozen_plain(frozen, obs, feats,
                                            torch.bfloat16)
    before = equinet_lib.equinet_frozen.launches
    got = equinet_lib.equinet_frozen(frozen, obs, feats, torch.bfloat16)
    torch.cuda.synchronize()
    assert equinet_lib.equinet_frozen.launches == before + 1
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.shape == y.shape and x.dtype == torch.float32
    for name, d in equinet_probe.compare(frozen, got, want, feats).items():
        assert d["nonfinite"] == 0, (name, d)
        assert d["differ_share"] <= K4_DIFFER_SHARE, (name, d)
        assert d["max_ulps"] <= K4_MAX_ULPS, (name, d)


@pytest.mark.cuda
def test_equinet_frozen_kernel_is_bitwise_at_the_flagships_shape(dev):
    """At the flagship's shape (A = 5, 64 channels, depth 2, primed: a
    heads' fan of 72) K4 sums every product as cuBLAS does, so its outputs
    are the eager passes' bit for bit."""
    frozen, obs, feats = _k4_inputs(dev, *K4_CASES["flagship"])
    want = equinet_lib.equinet_frozen_plain(frozen, obs, feats,
                                            torch.bfloat16)
    got = equinet_lib.equinet_frozen(frozen, obs, feats, torch.bfloat16)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.cuda
def test_equinet_frozen_kernel_is_deterministic(dev):
    frozen, obs, feats = _k4_inputs(dev, *K4_CASES["flagship"])
    a = equinet_lib.equinet_frozen(frozen, obs, feats, torch.bfloat16)
    b = equinet_lib.equinet_frozen(frozen, obs, feats, torch.bfloat16)
    assert all(torch.equal(x, y) for g, h in zip(a, b) for x, y in zip(g, h))
    # the values left out are not written, the others the same
    c = equinet_lib.equinet_frozen(frozen, obs, feats, torch.bfloat16,
                                   values=(True, False, False))
    assert c[1][1] is None and c[2][1] is None
    assert torch.equal(c[0][1], a[0][1])
    assert all(torch.equal(c[k][0], a[k][0]) for k in range(3))


@pytest.mark.cuda
def test_equinet_frozen_kernel_rejects(dev):
    """``unsupported`` names what the kernel does not take, on the card
    too, and the kernel's own entry point refuses the shapes."""
    frozen, obs, feats = _k4_inputs(dev, *K4_CASES["flagship"])
    bf16 = torch.bfloat16
    assert equinet_lib.unsupported(frozen, obs, feats, bf16) is None
    assert "dtype" in equinet_lib.unsupported(frozen, obs, feats,
                                              torch.float32)
    assert "observations" in equinet_lib.unsupported(frozen, obs[:, :1],
                                                     feats, bf16)
    for A, C, why in ((9, 64, "A = 9"), (5, 72, "C = 72")):
        bad = equinet_probe.frozen_nets(A, C, 1, 0, False, 0, dev)
        assert why in equinet_lib.unsupported(
            bad, equinet_probe.observations(4, A, 0, dev), None, bf16)
    fn = _build.entry("equinet", "rnad_equinet_frozen", equinet_lib.ARGTYPES)
    out = torch.empty(64, device=dev)
    ptrs = (ctypes.c_void_p * 5)(*[out.data_ptr()] * 5)
    stream = torch.cuda.current_stream().cuda_stream
    for A, C, depth, k in ((9, 64, 2, 3), (5, 72, 2, 3), (5, 64, 0, 3),
                           (5, 64, 2, 5)):
        err = fn(obs.data_ptr(), None, None, None, out.data_ptr(), 1,
                 ctypes.addressof(ptrs), ctypes.addressof(ptrs), 4, A, 2, C,
                 depth, k, 0, stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check("equinet", "rnad_equinet_frozen", err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,per_turn", [("bfloat16", 1), ("float32", 0)])
def test_k4_engages_once_a_turn_and_once_a_bf16_equinet_learner_step(
        dev, dtype, per_turn):
    """A bf16 EquiNet's step launches K4 once in each rollout turn (the
    generic turn's no-grad forward) and twice in the learner (the frozen
    passes, and the learner's own forward under ``forward_train``), and
    K5 once (the learner's backward): 2 + T K4 launches a step of T turns;
    a float32 one stays eager.  The step's loss is finite."""
    tree = _tree("cpu", depth=4).to(dev)
    packed = stepping.make_packed_tables(tree)
    cfg = RNaDConfig(batch_size=256, eta=0.5, lr=5e-5, logit_clip=2.0)
    net = nets.build_net(dataclasses.replace(EQUI, compute_dtype=dtype),
                         torch.Generator().manual_seed(4)).to(dev)
    state = rnad.init_train_state(net, torch.Generator(device=dev))
    before = equinet_lib.equinet_frozen.launches
    before_k5 = equinet_lib.equinet_backward.launches
    for _ in range(2):
        traj = rnad.rollout(state, tree, packed, cfg)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        assert torch.isfinite(metrics["loss"]).all()
    assert equinet_lib.equinet_frozen.launches - before == (
        2 * per_turn * (2 + tree.max_depth))
    assert equinet_lib.equinet_backward.launches - before_k5 == 2 * per_turn


# one net's no-grad forward through K4 (``equinet.forward_no_grad``): a
# flagship rollout turn's 65,536 observations (two seats of 32,768 lanes)
# and a flagship NashConv chunk's 41,942 (20,971 nodes)
K4_ONE_NET = {"rollout_turn": 65536, "nashconv_chunk": 41942}


def _flagship_net(dev, seed, solver_iters=32):
    """A bf16 EquiNet of the flagship's shape, its primed heads drawn."""
    return equinet_probe.frozen_nets(5, 64, 2, solver_iters, True, seed,
                                     dev)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_ONE_NET))
def test_forward_no_grad_kernel_vs_eager(dev, case):
    """One bf16 EquiNet of the flagship's shape through
    ``forward_no_grad`` (one K4 launch on its packed parameters) against
    ``net(obs)`` on the same solver features."""
    net = _flagship_net(dev, 3)
    obs = equinet_probe.observations(K4_ONE_NET[case], 5, 4, dev)
    feats = equinet_lib.solver_features(net, obs)
    assert equinet_lib.unsupported([net], obs, feats, net.dtype) is None
    want = net(obs, feats)
    before = equinet_lib.equinet_frozen.launches
    got = equinet_lib.forward_no_grad(net, obs, equinet_lib.pack([net]))
    torch.cuda.synchronize()
    assert equinet_lib.equinet_frozen.launches == before + 1
    assert [t.shape for t in got] == [t.shape for t in want]
    diffs = equinet_probe.compare((net,), [got], [want], feats)
    for name, d in diffs.items():
        assert d["nonfinite"] == 0, (name, d)
        assert d["differ_share"] <= K4_DIFFER_SHARE, (name, d)
        assert d["max_ulps"] <= K4_MAX_ULPS, (name, d)


def _eager_forward(monkeypatch):
    monkeypatch.setattr(equinet_lib, "forward_no_grad",
                        lambda net, obs, *a, **k: net(obs))


@pytest.mark.cuda
def test_rollout_with_k4_is_the_eager_rollout(dev, monkeypatch):
    """A flagship-shaped rollout (the primed bf16 EquiNet 64 x 2, A = 5,
    32,768 lanes) with K4 in every generic turn plays the eager rollout's
    episodes on the same noise: indices, actions, rewards, observations
    and the policy and values equal."""
    tree = _tree("cpu", A=5, depth=4).to(dev)
    packed = stepping.make_packed_tables(tree)
    net = _flagship_net(dev, 5, solver_iters=128)
    B, A, T = 32768, tree.max_actions, tree.max_transitions
    gen = torch.Generator(device=dev).manual_seed(6)
    noise = [engine.turn_noise(B, A, T, gen, dev)
             for _ in range(tree.max_depth)]
    init = torch.ones((B,), dtype=torch.int32, device=dev)
    play = lambda: engine.rollout_from(tree, packed, net, init, noise=noise,
                                       store_obs=True)
    before = equinet_lib.equinet_frozen.launches
    fused = play()
    assert equinet_lib.equinet_frozen.launches - before == tree.max_depth
    _eager_forward(monkeypatch)
    eager = play()
    for f in ("indices", "actions", "rewards", "obs", "policy", "values"):
        assert torch.equal(getattr(fused, f), getattr(eager, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3])
def test_nashconv_with_k4_is_the_eager_nashconv(dev, monkeypatch, chunks):
    """Exact NashConv of a bf16 EquiNet with K4 (one launch a chunk, or
    one for the whole tree) within 1e-6 of the eager forward's."""
    tree = _tree("cpu", A=5, depth=4).to(dev)
    net = _flagship_net(dev, 7)
    chunk = None if chunks == 1 else -(-tree.size // chunks)
    before = equinet_lib.equinet_frozen.launches
    got = float(rnad.nashconv(tree, net, chunk).nashconv())
    assert equinet_lib.equinet_frozen.launches - before == chunks
    _eager_forward(monkeypatch)
    want = float(rnad.nashconv(tree, net, chunk).nashconv())
    assert abs(got - want) <= 1e-6, (got, want)


# K5 (the trainable net's backward) against eager autograd: each leaf's
# largest gap over the leaf's largest magnitude (equinet_probe.leaf_gaps)
K5_LEAF_GAP = 0.02
K5_CASES = {  # (n, A, C, depth, solver_iters, primed)
    "flagship_393216": (393216, 5, 64, 2, 32, True),
    "a3_unprimed_c0_2": (3001, 3, 16, 2, 0, False),
    "a4_c32_depth3": (2000, 4, 32, 3, 8, True),
    "a8_ragged": (17, 8, 64, 2, 8, False),
    "one_observation": (1, 2, 48, 1, 8, True),
}


def _k5_holds(res):
    assert res["forward_bitwise"], res
    assert res["deterministic"] and res["nonfinite"] == 0, res
    for name, d in res["k5"].items():
        assert d["rel_gap"] <= K5_LEAF_GAP, (name, res["k5"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_equinet_backward_kernel_vs_eager_autograd(dev, case):
    """The learner's pass on K4 and K5 (``forward_train``) with random
    nonzero gradients of the logits and values: the forward bitwise the
    eager one, each leaf's gradient within ``K5_LEAF_GAP`` of eager
    autograd's (at the flagship's shape over 393,216 observations, as the
    learner runs it; unprimed without solver features; three layers; A =
    8 with a ragged tile; one observation), two backward launches bitwise
    equal."""
    n, A, C, depth, iters, primed = K5_CASES[case]
    before = equinet_lib.equinet_backward.launches
    res = equinet_probe.train_probe(n, A, C, depth, iters, primed, iters=1)
    assert equinet_lib.equinet_backward.launches > before
    _k5_holds(res)


@pytest.mark.cuda
def test_equinet_backward_kernel_splits_tied_maxima(dev):
    """Payoffs rounded to halves, so that many cells of a row or column
    tie in the max pools: K5 splits their gradient as autograd does."""
    _k5_holds(equinet_probe.train_probe(65536, iters=1, ties=True))


@pytest.mark.cuda
def test_equinet_backward_kernel_rejects(dev):
    """``backward_unsupported`` names the widths and depths K5 does not
    take (the learner keeps the eager pass there), and the kernel's entry
    point refuses them."""
    bf16 = torch.bfloat16
    for A, C, depth, why in ((5, 128, 2, "C = 128"),
                             (5, 64, 3, "depth 3 at C = 64")):
        net = equinet_probe.frozen_nets(A, C, depth, 8, True, 0, dev)[0]
        obs = equinet_probe.observations(4, A, 0, dev)
        feats = equinet_lib.solver_features(net, obs)
        assert equinet_lib.unsupported([net], obs, feats, bf16) is None
        assert why in equinet_lib.backward_unsupported(net)
        assert not equinet_lib.trains(net, obs, feats)
    fn = _build.entry("equinet", "rnad_equinet_backward",
                      equinet_lib.BACKWARD_ARGTYPES)
    buf = torch.zeros(4096, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for A, C, depth in ((9, 64, 2), (5, 128, 1), (5, 64, 3), (5, 24, 1)):
        err = fn(buf.data_ptr(), None, None, None, buf.data_ptr(), 1,
                 buf.data_ptr(), buf.data_ptr(), buf.data_ptr(), 1,
                 buf.data_ptr(), 4, A, 2, C, depth, 0, stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check("equinet", "rnad_equinet_backward", err)


@pytest.mark.cuda
def test_learner_step_on_k5_is_the_eager_steps_loss(dev, monkeypatch):
    """A flagship-shaped bf16 EquiNet's learner step with its pass on K4
    and K5 reports the eager step's loss bit for bit (the forward is K4's,
    bitwise) and updates the weights within two learning rates of it (a
    gradient element that parts by a bf16 rounding moves Adam's step by
    at most the rate)."""
    tree = _tree("cpu", A=5, depth=4).to(dev)
    packed = stepping.make_packed_tables(tree)
    cfg = RNaDConfig(batch_size=4096, eta=0.5, lr=5e-5, logit_clip=2.0)
    net = _flagship_net(dev, 9, solver_iters=32).requires_grad_(True)
    state = rnad.init_train_state(net, torch.Generator(device=dev))
    traj = rnad.rollout(state, tree, packed, cfg)

    def step():
        s = copy.deepcopy(state)
        before = equinet_lib.equinet_backward.launches
        metrics = rnad.learn_step(s, packed, traj, 0.5, cfg)
        return (metrics, equinet_lib.equinet_backward.launches - before,
                [p.detach().clone() for p in s.net.parameters()])

    fused, k5, weights = step()
    monkeypatch.setattr(equinet_lib, "trains", lambda *a: False)
    eager, k5_eager, weights_eager = step()
    assert (k5, k5_eager) == (1, 0)
    assert torch.equal(fused["loss"], eager["loss"])
    for w, v in zip(weights, weights_eager):
        assert float((w - v).abs().max()) <= 2 * cfg.lr
