"""rnad_tpu_torch's RM+ solver (the plain version of kernel K3 and
env/solver_device.py) against rnad_tpu's ``rmplus_core`` and the Pallas
kernel in interpret mode.

Criterion (``solver_device.agreement``): x, y and v within atol 1e-5 except
on a counted share (at most 3 %) of games where float32 rounding, summed in
another order, clipped a regret hovering at 0 in one run and not in the
other.  Those games' exploitability may differ either way, but as a set
they are as good as the reference's: mean exploitability within 1e-5 over
all games and 2e-3 over the diverged ones, worst game within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.env import solver_device as jax_sd
from rnad_tpu.ops import pallas_rmplus
from rnad_tpu_torch.env import solver_device as torch_sd
from rnad_tpu_torch.models import nets as torch_nets
from rnad_tpu_torch.ops import rmplus as rmplus_lib
from rnad_tpu_torch.ops import stepping
from tests.torch_parity import torch_tree


def _random_games(seed, B, R, C):
    rng = np.random.default_rng(seed)
    M = rng.uniform(-1, 1, (B, R, C)).astype(np.float32)
    lr = (rng.random((B, R)) > 0.2).astype(np.float32)
    lc = (rng.random((B, C)) > 0.2).astype(np.float32)
    lr[:, 0] = 1.0  # at least one legal action a seat
    lc[:, 0] = 1.0
    return M * lr[:, :, None] * lc[:, None, :], lr, lc


def _assert_agree(M, lr, lc, got, want):
    """``got`` (torch) and ``want`` (numpy or jax), both batch-major
    (x (B, R), y (B, C), v (B,))."""
    t = lambda a: torch.as_tensor(np.array(a))
    result = torch_sd.agreement(t(M), t(lr), t(lc), got[:2],
                                [t(w) for w in want[:2]], got[2], t(want[2]))
    assert result.ok, result
    return result


@pytest.mark.parametrize("iters", [64, 128])
def test_plain_matches_core_and_pallas(iters):
    M, lr, lc = _random_games(0, 300, 5, 5)
    Mz = np.ascontiguousarray(M.transpose(1, 2, 0))
    args = (jnp.asarray(Mz), jnp.asarray(lr.T), jnp.asarray(lc.T))
    core = jax_sd.rmplus_core(*args, iters)
    pallas = pallas_rmplus.rmplus(*args, iters, interpret=True)
    x, y, v = rmplus_lib.rmplus_plain(
        torch.from_numpy(Mz), torch.from_numpy(np.ascontiguousarray(lr.T)),
        torch.from_numpy(np.ascontiguousarray(lc.T)), iters)
    got = (x.t(), y.t(), v)
    for want in (core, pallas):
        wx, wy, wv = (np.asarray(a) for a in want)
        _assert_agree(M, lr, lc, got, (wx.T, wy.T, wv))


def test_plain_matches_on_observed_tree_games(small_tree):
    """Both seats' observed games of every node of the small tree."""
    tree = torch_tree(small_tree)
    ev = tree.expected_value[:, 0]
    lg = tree.legal[:, 0]
    M = torch.cat([ev, -ev.transpose(1, 2)])
    lg2 = torch.cat([lg, lg.transpose(1, 2)])
    lr, lc = lg2.amax(2), lg2.amax(1)
    got = torch_sd.solve_zero_sum_rmplus(M, lr, lc, iters=128)
    want = jax_sd.solve_zero_sum_rmplus(jnp.asarray(M.numpy()),
                                        jnp.asarray(lr.numpy()),
                                        jnp.asarray(lc.numpy()), iters=128)
    Mz = (M * lr[:, :, None] * lc[:, None, :]).numpy()
    _assert_agree(Mz, lr, lc, got, want)
    pallas = pallas_rmplus.rmplus(
        jnp.asarray(Mz.transpose(1, 2, 0)), jnp.asarray(lr.numpy().T),
        jnp.asarray(lc.numpy().T), 128, interpret=True)
    _assert_agree(Mz, lr, lc, got,
                  (np.asarray(pallas[0]).T, np.asarray(pallas[1]).T,
                   pallas[2]))


def test_solve_and_exploitability_match_jax():
    """A (B, 3, 4) batch: the solve through the batch-minor transposes, and
    exploitability_batch on identical strategies."""
    M, lr, lc = _random_games(1, 257, 3, 4)
    raw = np.random.default_rng(2).uniform(-1, 1, M.shape).astype(np.float32)
    got = torch_sd.solve_zero_sum_rmplus(torch.from_numpy(raw),
                                         torch.from_numpy(lr),
                                         torch.from_numpy(lc), iters=64)
    want = jax_sd.solve_zero_sum_rmplus(jnp.asarray(raw), jnp.asarray(lr),
                                        jnp.asarray(lc), iters=64)
    Mz = raw * lr[:, :, None] * lc[:, None, :]
    _assert_agree(Mz, lr, lc, got, want)
    assert got[0].shape == (257, 3) and got[1].shape == (257, 4)
    x, y = np.asarray(want[0]), np.asarray(want[1])
    e_w = jax_sd.exploitability_batch(jnp.asarray(Mz), jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(lr),
                                      jnp.asarray(lc))
    e_g = torch_sd.exploitability_batch(*(torch.from_numpy(np.asarray(a))
                                          for a in (Mz, x, y, lr, lc)))
    np.testing.assert_allclose(e_g.numpy(), np.asarray(e_w), rtol=0,
                               atol=1e-6)


def test_joint_policy_rmplus_matches_jax(small_tree):
    tree = torch_tree(small_tree)
    got = torch_sd.joint_policy_rmplus(tree, iters=64, chunk=50)
    want = np.asarray(jax_sd.joint_policy_rmplus(small_tree, iters=64,
                                                 chunk=50))
    A = tree.max_actions
    assert got.shape == want.shape == (tree.size, 2 * A)
    ev = tree.expected_value[:, 0]
    lg = tree.legal[:, 0]
    lr, lc = lg[:, :, 0], lg[:, 0, :]
    Mz = ev * lr[:, :, None] * lc[:, None, :]
    v = lambda j: torch.einsum("br,brc,bc->b", j[:, :A], Mz, j[:, A:])
    want_t = torch.from_numpy(want)
    result = torch_sd.agreement(Mz, lr, lc, (got[:, :A], got[:, A:]),
                                (want_t[:, :A], want_t[:, A:]), v(got),
                                v(want_t))
    assert result.ok, result


def test_solution_quality():
    """The averaged strategies are an epsilon-Nash of each game, checked
    through the exploitability oracle (tests/test_pallas_rmplus.py)."""
    M, lr, lc = _random_games(7, 128, 4, 4)
    x, y, _ = torch_sd.solve_zero_sum_rmplus(
        torch.from_numpy(M), torch.from_numpy(lr), torch.from_numpy(lc),
        iters=512)
    expl = torch_sd.exploitability_batch(torch.from_numpy(M), x, y,
                                         torch.from_numpy(lr),
                                         torch.from_numpy(lc))
    assert float(expl.max()) < 0.05
    assert torch.allclose(x.sum(1), torch.ones(128), atol=1e-6)


def test_wrapper_launches_nothing_on_cpu():
    M, lr, lc = _random_games(3, 100, 5, 5)
    args = (torch.from_numpy(np.ascontiguousarray(M.transpose(1, 2, 0))),
            torch.from_numpy(np.ascontiguousarray(lr.T)),
            torch.from_numpy(np.ascontiguousarray(lc.T)))
    before = rmplus_lib.rmplus.launches
    got = rmplus_lib.rmplus(*args, 32)
    want = rmplus_lib.rmplus_plain(*args, 32)
    assert rmplus_lib.rmplus.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    empty = rmplus_lib.rmplus(torch.zeros((5, 5, 0)), torch.zeros((5, 0)),
                              torch.zeros((5, 0)), 8)
    assert [t.shape for t in empty] == [(5, 0), (5, 0), (0,)]


@pytest.mark.parametrize("R,C", [(17, 5), (5, 17)])
def test_more_than_16_actions_raise(R, C):
    with pytest.raises(ValueError, match="R, C <= 16"):
        rmplus_lib.rmplus(torch.zeros((R, C, 4)), torch.zeros((R, 4)),
                          torch.zeros((C, 4)), 8)


def test_wrapper_checks_its_arguments():
    M, lr, lc = torch.zeros((5, 5, 4)), torch.zeros((5, 4)), torch.zeros((5, 4))
    with pytest.raises(TypeError, match="M"):
        rmplus_lib.rmplus(M.double(), lr, lc, 8)
    with pytest.raises(ValueError, match="lc"):
        rmplus_lib.rmplus(M, lr, torch.zeros((4, 4)), 8)
    with pytest.raises(ValueError, match="contiguous"):
        rmplus_lib.rmplus(M.transpose(0, 1), lr, lc, 8)
    with pytest.raises(ValueError, match="iters"):
        rmplus_lib.rmplus(M, lr, lc, -1)


def test_masks_are_zero_one_and_illegal_regrets_stay_zero(small_tree,
                                                          monkeypatch):
    """The mask contract kernel K3's exact cuts rely on.  The masks that
    the EquiNet's solver features and ``joint_policy_rmplus`` hand to
    ``rmplus`` hold only 0.0 and 1.0; given such masks, every regret and
    running average that ``rmplus_plain`` normalizes is exactly +0 on the
    illegal actions, so its product by the mask changes nothing."""
    tree = torch_tree(small_tree)
    seen = []
    real = torch_sd.rmplus

    def record(M, lr, lc, iters):
        seen.append((M, lr, lc))
        return real(M, lr, lc, iters)

    monkeypatch.setattr(torch_sd, "rmplus", record)
    packed = stepping.make_packed_tables(tree)
    rows = stepping.lookup(packed, torch.arange(tree.size, dtype=torch.int32))
    obs = torch.cat(stepping.slice_observations(packed, rows))
    torch_nets._solver_features(obs.permute(0, 2, 3, 1), iters=16)
    torch_sd.joint_policy_rmplus(tree, iters=16, chunk=50)
    assert len(seen) == 1 + -(-tree.size // 50)
    illegal = 0
    for _, lr, lc in seen:
        for mask in (lr, lc):
            assert bool(((mask == 0) | (mask == 1)).all())
            illegal += int((mask == 0).sum())
    assert illegal > 0  # the tree has illegal actions to check

    normalized = []
    plain_normalize = rmplus_lib._normalize

    def check(q, legal):
        off = q[legal == 0]
        assert bool((off == 0).all()) and not bool(torch.signbit(off).any())
        assert torch.equal(q * legal, q)
        normalized.append(int((legal == 0).sum()))
        return plain_normalize(q, legal)

    monkeypatch.setattr(rmplus_lib, "_normalize", check)
    M, lr, lc = _random_games(5, 500, 5, 5)
    games = seen + [(torch.from_numpy(np.ascontiguousarray(M.transpose(1, 2,
                                                                       0))),
                     torch.from_numpy(np.ascontiguousarray(lr.T)),
                     torch.from_numpy(np.ascontiguousarray(lc.T)))]
    for M, lr, lc in games:
        rmplus_lib.rmplus_plain(M, lr, lc, 32)
    assert sum(normalized) > 0


def test_operation_count():
    """The count the bound uses: 4RC + 10R + 11C + 3 per iteration, the
    products by a {0, 1} mask left out."""
    assert rmplus_lib.operations(5, 5, 1) - rmplus_lib.operations(5, 5, 0) \
        == 208
    assert rmplus_lib.operations(5, 5, 128) == 128 * 208 + 30 + 2 + 75
    assert rmplus_lib.io_bytes(5, 5, 327680) == 4 * 327680 * 46


def test_plain_handles_masks_other_than_zero_one():
    """``rmplus`` takes any mask: with values between 0 and 1 the products
    by the mask count, and the plain version computes rnad_tpu's
    ``rmplus_core`` (kernel K3 keeps those products for such games).  RM+
    does not converge under such masks, and two float32 orders part on a
    growing share of games as the iterations go on (4 % at 32), so the
    check runs 16 iterations."""
    M, lr, lc = _random_games(9, 400, 5, 5)
    rng = np.random.default_rng(10)
    lr = (lr * rng.choice([0.25, 0.5, 1.0], lr.shape)).astype(np.float32)
    lc = (lc * rng.choice([0.25, 0.5, 1.0], lc.shape)).astype(np.float32)
    assert ((lr > 0) & (lr < 1)).any() and ((lc > 0) & (lc < 1)).any()
    Mz = np.ascontiguousarray(M.transpose(1, 2, 0))
    lrm, lcm = np.ascontiguousarray(lr.T), np.ascontiguousarray(lc.T)
    want = jax_sd.rmplus_core(jnp.asarray(Mz), jnp.asarray(lrm),
                              jnp.asarray(lcm), 16)
    x, y, v = rmplus_lib.rmplus(torch.from_numpy(Mz), torch.from_numpy(lrm),
                                torch.from_numpy(lcm), 16)
    wx, wy, wv = (np.asarray(a) for a in want)
    _assert_agree(M, lr, lc, (x.t(), y.t(), v), (wx.T, wy.T, wv))
