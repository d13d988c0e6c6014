"""Replay buffer of rollout batches.

Counterpart of ``rnad_tpu/learn/buffer.py``: a deque of whole rollout
batches, sampled with the static equal split across slots and collated
along the lane axis.  Every trajectory of a tree has the same length
(2 * max_depth), so collation is a concatenation along the lanes.  The
default configuration (``n_batches_per_buffer=1, buffer_mod=1``) is the
on-policy step, which bypasses the buffer.

``plan`` makes ``rnad_tpu``'s numpy calls in its order, so from equal
``np.random.Generator``s the two packages pick the same lanes.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..env.engine import Trajectory
from ..utils import timing


# every field has its lanes along axis 1
LANE_FIELDS = tuple(f.name for f in dataclasses.fields(Trajectory))


def collate_slots(slots: Sequence[Trajectory],
                  lanes: Sequence[torch.Tensor]) -> Trajectory:
    """Gathers ``lanes[i]`` along lane axis 1 of every field of
    ``slots[i]`` (``obs`` included where stored) and concatenates."""
    fields = {}
    for name in LANE_FIELDS:
        parts = [getattr(t, name) for t in slots]
        fields[name] = (None if parts[0] is None else torch.cat(
            [p[:, lane] for p, lane in zip(parts, lanes)], dim=1))
    return Trajectory(**fields)


class TrajectoryBuffer:
    """Whole rollout batches, oldest evicted first beyond ``max_size``
    (which the trainer may change between update periods)."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self.slots: deque = deque()

    def __len__(self) -> int:
        return len(self.slots)

    def append(self, traj: Trajectory) -> None:
        self.slots.append(traj)
        while len(self.slots) > self.max_size:
            self.slots.popleft()

    def clear(self) -> None:
        self.slots.clear()

    def sample(self, batch_size: int,
               rng: Optional[np.random.Generator] = None,
               group=None) -> Trajectory:
        """Exactly ``batch_size`` lanes, collated (see ``plan``).

        Under ``group`` (a ``parallel.mesh.DataGroup``) each slot holds this
        rank's lanes of one global rollout (global lane L on rank L // (B /
        world), B the rollout's global lanes) and the result is this rank's
        positions of the global collated batch, ``group.lanes(batch_size)``:
        every rank draws the global plan from an equal ``rng``, writes the
        rows it owns into a zero-filled collated global batch, one flat
        buffer per dtype (int32: ``indices``, ``actions``; float32:
        ``policy``, ``rewards``, ``values`` and stored ``obs``, cast to
        float32 and back, which is exact), all-reduces (SUM) each and keeps
        its own positions.  Each position is written by one rank, so the
        sum is exact (gloo has no ``all_gather`` of CUDA
        tensors, and one path serves both backends, as in ``metrics/
        nashconv_shard.py``); the one change is that -0.0 arrives as +0.0,
        which ``torch.equal`` counts as equal.  At A = 5 a lane carries 36
        bytes a half-step (``indices``, ``actions``, ``rewards``,
        ``values`` and five policy floats) and the stored raw ``obs`` 2 *
        A * A * 4 = 200 more (``store_rollout_obs``, the default), 236 in
        all: 92.8 MB a learner step at r5-offpol-32k's B = 32768 and T =
        12 (14.2 MB without the observations); a lift's stored ``obs``
        takes (C + 1) * A * A * 4 bytes a half-step.  Over one rank the
        exchange is the identity: ``collate_slots``'s batch."""
        with timing.span("rnad.buffer.sample"):
            if group is None:
                slots, lanes = self.plan(batch_size, rng)
                if lanes is None:
                    return slots[0]
                return collate_slots(slots, lanes)
            return self._exchange(batch_size, rng, group)

    def plan(self, batch_size: int,
             rng: Optional[np.random.Generator] = None):
        """The sampling decision: ``(slots, lanes)`` for ``collate_slots``,
        or ``(slot,), None`` where one full slot is held.

        The split is static: ``batch_size // n`` lanes a slot, the remainder
        to the first slots, drawn without replacement within each slot; a
        slot smaller than its share adds with-replacement draws for the
        deficit.  Lane index tensors go to the slot's device, copied from
        pinned memory without a wait, so planning does not stall the
        card."""
        used, lanes_list = _draw([t.batch_size for t in self.slots],
                                 batch_size, rng)
        if lanes_list is None:
            return (self.slots[0],), None
        slots = tuple(self.slots[i] for i in used)
        return slots, tuple(_to(t.indices.device, lanes)
                            for t, lanes in zip(slots, lanes_list))

    def _exchange(self, batch_size: int, rng: Optional[np.random.Generator],
                  group) -> Trajectory:
        """``sample`` under ``group``: the global plan, then one all-reduce
        per dtype of the collated global batch."""
        world, rank = group.world, group.rank
        local = [t.batch_size for t in self.slots]
        used, lanes_list = _draw([n * world for n in local], batch_size, rng)
        if lanes_list is None:  # one full slot: this rank's lanes already
            return self.slots[0]
        first = self.slots[0]
        T, device = first.num_half_steps, first.indices.device
        names = [n for n in LANE_FIELDS if getattr(first, n) is not None]
        ints = [n for n in names if n in _INT_FIELDS]
        floats = [n for n in names if n not in _INT_FIELDS]
        width = lambda n: math.prod(getattr(first, n).shape[2:])
        packed = {torch.int32: (ints, torch.zeros(
                      (T, batch_size, sum(map(width, ints))),
                      dtype=torch.int32, device=device)),
                  torch.float32: (floats, torch.zeros(
                      (T, batch_size, sum(map(width, floats))),
                      dtype=torch.float32, device=device))}
        start = 0
        for i, lanes in zip(used, lanes_list):
            mine = np.flatnonzero(lanes // local[i] == rank)
            pos = _to(device, start + mine)
            rows = _to(device, lanes[mine] - rank * local[i])
            slot = self.slots[i]
            for dtype, (fields, buf) in packed.items():
                buf[:, pos] = torch.cat(
                    [getattr(slot, n)[:, rows].reshape(T, len(mine), width(n))
                     .to(dtype) for n in fields], dim=2)
            start += len(lanes)
        mine = group.lanes(batch_size)
        out = {}
        for dtype, (fields, buf) in packed.items():
            buf = group.global_sum(buf)[:, mine]
            for n, part in zip(fields, buf.split(list(map(width, fields)),
                                                 dim=2)):
                ref = getattr(first, n)
                out[n] = part.reshape((T, part.shape[1]) + ref.shape[2:]).to(
                    ref.dtype).contiguous()
        return Trajectory(**out)


_INT_FIELDS = ("indices", "actions")


def _to(device: torch.device, lanes: np.ndarray) -> torch.Tensor:
    """Host lane indices on ``device``; to the card from pinned memory
    without a wait, so planning does not stall the card's queue."""
    lanes = torch.from_numpy(lanes)
    if device.type == "cuda":
        return lanes.pin_memory().to(device, non_blocking=True)
    return lanes


def _draw(sizes: Sequence[int], batch_size: int,
          rng: Optional[np.random.Generator] = None):
    """``TrajectoryBuffer.plan``'s draws in numpy, for slots of ``sizes``
    lanes: (the slots drawn from, by position, and their lanes), or
    ``((0,), None)`` where one slot holds exactly ``batch_size``.  The
    numpy calls are ``rnad_tpu``'s, in its order."""
    n = len(sizes)
    if n == 0:
        raise ValueError("sampling from an empty buffer")
    if n == 1 and sizes[0] == batch_size:
        return (0,), None
    rng = rng or np.random.default_rng()
    counts = np.full((n,), batch_size // n, np.int64)
    counts[:batch_size % n] += 1
    used, lanes_list = [], []
    for i, (count, size) in enumerate(zip(counts, sizes)):
        if count == 0:
            continue
        take = min(int(count), int(size))
        lanes = rng.choice(size, size=take, replace=False)
        if take < count:  # slot smaller than its share: replacement
            lanes = np.concatenate(
                [lanes, rng.choice(size, size=int(count) - take,
                                   replace=True)])
        used.append(i)
        lanes_list.append(lanes)
    return tuple(used), tuple(lanes_list)
