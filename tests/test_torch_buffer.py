"""rnad_tpu_torch.learn.buffer against rnad_tpu.learn.buffer.

From equal ``np.random.Generator``s, ``TrajectoryBuffer.plan`` picks the
same slots and the same lanes, bitwise, at every fill level, with a slot
shorter than its share and on the one-full-slot fast path; ``collate_slots``
gives the same trajectory, stored observations included; eviction follows a
``max_size`` changed between appends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnad_tpu.env.engine import Trajectory as JaxTrajectory
from rnad_tpu.learn import buffer as jax_buffer
from rnad_tpu_torch.learn import buffer as torch_buffer
from tests.torch_parity import torch_trajectory

T, A = 6, 3


def _traj(seed, B, obs=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return JaxTrajectory(
        indices=jnp.asarray(rng.integers(0, 50, (T, B)), jnp.int32),
        policy=jnp.asarray(f(T, B, A)),
        actions=jnp.asarray(rng.integers(0, A, (T, B)), jnp.int32),
        rewards=jnp.asarray(f(T, B)), values=jnp.asarray(f(T, B)),
        obs=jnp.asarray(f(T, B, 9, A, A)) if obs else None)


def _buffers(sizes, obs=False):
    jb = jax_buffer.TrajectoryBuffer(len(sizes))
    tb = torch_buffer.TrajectoryBuffer(len(sizes))
    for i, B in enumerate(sizes):
        traj = _traj(i, B, obs)
        jb.append(traj)
        tb.append(torch_trajectory(traj))
    return jb, tb


@pytest.mark.parametrize("sizes,batch", [
    ([64], 64),  # one full slot: the fast path
    ([64], 48),  # one slot, a smaller batch
    ([64, 64], 64), ([64, 64, 64], 64), ([64, 64, 64, 64], 64),
    ([64, 64, 64, 64], 66),  # a remainder for the first slots
    ([64, 10, 64], 64),  # a slot shorter than its share: replacement
    ([8, 8, 8, 8], 64),  # every slot short
])
def test_plan_lanes_bitwise_equal(sizes, batch):
    jb, tb = _buffers(sizes)
    for draw in range(3):  # the generators stay in step across calls
        jrng = np.random.default_rng(11) if draw == 0 else jrng
        trng = np.random.default_rng(11) if draw == 0 else trng
        jslots, jlanes = jb.plan(batch, jrng)
        tslots, tlanes = tb.plan(batch, trng)
        assert len(tslots) == len(jslots)
        pos = lambda buf, slots: [next(i for i, x in enumerate(buf.slots)
                                       if x is s) for s in slots]
        assert pos(tb, tslots) == pos(jb, jslots)
        if jlanes is None:
            assert tlanes is None and sizes == [batch]
            continue
        for t, j in zip(tlanes, jlanes, strict=True):
            assert t.dtype == torch.int64
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert sum(len(t) for t in tlanes) == batch


@pytest.mark.parametrize("obs", [False, True])
def test_collate_matches(obs):
    jb, tb = _buffers([32, 16, 32], obs)
    jslots, jlanes = jb.plan(40, np.random.default_rng(2))
    tslots, tlanes = tb.plan(40, np.random.default_rng(2))
    want = jax_buffer.collate_slots(jslots, jlanes)
    got = torch_buffer.collate_slots(tslots, tlanes)
    for f in ("indices", "policy", "actions", "rewards", "values", "obs"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None
            continue
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(w),
                                      err_msg=f)
    assert got.batch_size == 40
    sampled = tb.sample(40, np.random.default_rng(2))
    assert torch.equal(sampled.policy, got.policy)


def test_eviction_follows_max_size():
    tb = torch_buffer.TrajectoryBuffer(2)
    trajs = [torch_trajectory(_traj(i, 4)) for i in range(5)]
    for t in trajs[:3]:
        tb.append(t)
    held = lambda: [next(i for i, t in enumerate(trajs) if t is s)
                    for s in tb.slots]
    assert held() == [1, 2]
    tb.max_size = 3
    tb.append(trajs[3])
    assert held() == [1, 2, 3]
    tb.max_size = 1
    tb.append(trajs[4])
    assert held() == [4] and len(tb) == 1
    assert tb.sample(4) is trajs[4]
    tb.clear()
    with pytest.raises(ValueError, match="empty buffer"):
        tb.plan(4)
