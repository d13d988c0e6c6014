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
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..env.engine import Trajectory


def collate_slots(slots: Sequence[Trajectory],
                  lanes: Sequence[torch.Tensor]) -> Trajectory:
    """Gathers ``lanes[i]`` along lane axis 1 of every field of
    ``slots[i]`` (``obs`` included where stored) and concatenates."""
    fields = {}
    for f in dataclasses.fields(Trajectory):
        parts = [getattr(t, f.name) for t in slots]
        fields[f.name] = (None if parts[0] is None else torch.cat(
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
               rng: Optional[np.random.Generator] = None) -> Trajectory:
        """Exactly ``batch_size`` lanes, collated (see ``plan``)."""
        slots, lanes = self.plan(batch_size, rng)
        if lanes is None:
            return slots[0]
        return collate_slots(slots, lanes)

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
        n = len(self.slots)
        if n == 0:
            raise ValueError("sampling from an empty buffer")
        if n == 1 and self.slots[0].batch_size == batch_size:
            return (self.slots[0],), None
        rng = rng or np.random.default_rng()
        sizes = np.array([t.batch_size for t in self.slots], dtype=np.int64)
        counts = np.full((n,), batch_size // n, np.int64)
        counts[:batch_size % n] += 1
        used, lanes_list = [], []
        for traj, count, size in zip(self.slots, counts, sizes):
            if count == 0:
                continue
            take = min(int(count), int(size))
            lanes = rng.choice(size, size=take, replace=False)
            if take < count:  # slot smaller than its share: replacement
                lanes = np.concatenate(
                    [lanes, rng.choice(size, size=int(count) - take,
                                       replace=True)])
            used.append(traj)
            lanes = torch.from_numpy(lanes)
            if traj.indices.is_cuda:
                lanes = lanes.pin_memory().to(traj.indices.device,
                                              non_blocking=True)
            lanes_list.append(lanes)
        return tuple(used), tuple(lanes_list)
