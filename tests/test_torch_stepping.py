"""rnad_tpu_torch.ops.stepping against rnad_tpu.ops.stepping on one tree.

Packed rows are bitwise equal except the log-chance lanes: XLA's float32
``log`` on the CPU is not correctly rounded (it differs from torch's, and
from float64 rounded to float32, by one ulp on about 14% of inputs), so
those lanes are held to 2 ulps (rtol 2.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.ops import stepping as jax_stepping
from rnad_tpu_torch.ops import stepping as torch_stepping
from tests.torch_parity import torch_tree


@pytest.fixture(scope="module")
def tables(small_tree):
    want = jax_stepping.make_packed_tables(small_tree)
    got = torch_stepping.make_packed_tables(torch_tree(small_tree))
    return want, got


def _log_lanes(packed):
    A, T = packed.max_actions, packed.max_transitions
    off = packed.trans_offset
    return np.concatenate([off + n * 3 * T + np.arange(T)
                           for n in range(A * A)])


def test_packed_rows_equal(tables):
    want, got = tables
    w = np.asarray(want.rows)
    g = got.rows.numpy()
    assert g.shape == w.shape and g.shape[1] % 128 == 0
    assert got.trans_offset == want.trans_offset
    log = _log_lanes(want)
    rest = np.setdiff1d(np.arange(w.shape[1]), log)
    np.testing.assert_array_equal(g[:, rest], w[:, rest])
    np.testing.assert_allclose(g[:, log], w[:, log], rtol=2.4e-7, atol=0)


def test_lookup_and_slices_equal(tables):
    want, got = tables
    rng = np.random.default_rng(0)
    idx = rng.integers(0, want.rows.shape[0], 512).astype(np.int32)
    rows_w = jax_stepping.lookup(want, jnp.asarray(idx))
    # same table in both: the lookup itself must be bit-exact
    same = torch_stepping.PackedTables(
        rows=torch.from_numpy(np.array(want.rows)),
        max_actions=got.max_actions, max_transitions=got.max_transitions)
    rows_g = torch_stepping.lookup(same, torch.from_numpy(idx))
    np.testing.assert_array_equal(rows_g.numpy(), np.asarray(rows_w))
    for fw, fg in ((jax_stepping.slice_observations,
                    torch_stepping.slice_observations),
                   (jax_stepping.slice_action_masks,
                    torch_stepping.slice_action_masks)):
        for a, b in zip(fw(want, rows_w), fg(same, rows_g)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_transition_equal_under_shared_noise(tables, seed):
    want, got = tables
    A, T = want.max_actions, want.max_transitions
    S = want.rows.shape[0]
    rng = np.random.default_rng(seed)
    B = 1024
    idx = rng.integers(0, S, B).astype(np.int32)
    rows_w = jax_stepping.lookup(want, jnp.asarray(idx))
    legal_r = np.asarray(jax_stepping.slice_action_masks(want, rows_w)[0])
    legal_c = np.asarray(jax_stepping.slice_action_masks(want, rows_w)[1])
    # legal actions only (argmax of masked noise)
    ra = np.argmax(rng.random((B, A)) * legal_r, axis=1).astype(np.int32)
    ca = np.argmax(rng.random((B, A)) * legal_c, axis=1).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    new_w, rew_w = jax_stepping.select_transition(
        want, rows_w, jnp.asarray(ra), jnp.asarray(ca), key)
    g_ch = np.array(jax.random.gumbel(key, (T, B), jnp.float32)).T
    rows_g = got.rows[torch.from_numpy(idx).long()]
    new_g, rew_g = torch_stepping.select_transition(
        got, rows_g, torch.from_numpy(ra), torch.from_numpy(ca),
        torch.from_numpy(np.ascontiguousarray(g_ch)))
    np.testing.assert_array_equal(new_g.numpy(), np.asarray(new_w))
    np.testing.assert_array_equal(rew_g.numpy(), np.asarray(rew_w))
    assert new_g.dtype == torch.int32


def test_seat_observations_equal(small_tree):
    tt = torch_tree(small_tree)
    want = jax_stepping.seat_observations(small_tree.expected_value,
                                          small_tree.legal)
    got = torch_stepping.seat_observations(tt.expected_value, tt.legal)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
