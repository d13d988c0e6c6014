"""The explicit-collective data-parallel steps.

Counterpart of ``rnad_tpu/parallel/shard_map_step.py``.  There
``jax.shard_map`` runs a per-shard program with hand-placed ``psum`` /
``pmean`` collectives; here every rank runs its program and the
collectives are ``torch.distributed`` all-reduces (``mesh.DataGroup``).

Numerical relationship to the global-stream path (``runtime.py``):

  * The **learner update on a fixed global trajectory**
    (:func:`make_shard_map_learn_step`) takes this rank's slice of the
    lanes and equals the one-device ``learn_step`` up to summation order:
    every masked mean is this rank's numerator over the global valid
    count, and the gradients are summed over the ranks.
  * The **fused step** (:func:`make_shard_map_train_step`) rolls out
    *different episodes* than the global-stream path by construction: each
    step draws one seed from the replicated ``state.generator`` and each
    rank seeds its own generator from (that seed, its rank), as ``rnad_tpu``
    folds the data-axis index into the rollout key, so each rank samples an
    independent stream.  Both are unbiased samples of the same on-policy
    distribution; they are not step-for-step identical.

The optimizer and EMA updates run on the summed gradients on every rank,
so the weights stay bitwise identical across ranks.  A ConvNet is run here
with ``rnad_tpu``'s non-sync BatchNorm: its batch statistics normalize over
each rank's valid lanes, and the running statistics are averaged over the
ranks after the update, so every rank carries identical buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import RNaDConfig
from ..env import engine
from ..env.tree import GameTree
from ..learn import buffer as buffer_lib
from ..learn import rnad as rnad_lib
from ..ops import stepping
from ..ops.obs_transform import ObsTransform
from .mesh import DataGroup


def rank_seed(seed: int, rank: int) -> int:
    """A 64-bit seed that depends on both the step's seed and the rank."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0])


def make_shard_map_train_step(tree: GameTree, cfg: RNaDConfig,
                              group: DataGroup,
                              obs_transform: Optional[ObsTransform] = None):
    """Returns ``train_step(state, alpha) -> (state, metrics)``: one update
    with an independent rollout stream a rank (module docstring), its
    ``batch_size / world`` lanes, and the group-aware ``learn_step``."""
    lanes = group.lanes(cfg.batch_size)
    local_cfg = dataclasses.replace(cfg, batch_size=lanes.stop - lanes.start)
    packed = stepping.make_packed_tables(tree)

    def train_step(state: rnad_lib.TrainState, alpha: float
                   ) -> Tuple[rnad_lib.TrainState, Dict[str, torch.Tensor]]:
        seed = int(torch.randint(0, 2**62, (1,), generator=state.generator,
                                 device=state.generator.device))
        generator = torch.Generator(device=group.device)
        generator.manual_seed(rank_seed(seed, group.rank))
        traj = engine.rollout_from(
            tree, packed, state.net,
            torch.ones((local_cfg.batch_size,), dtype=torch.int32,
                       device=group.device),
            tree.max_depth, generator=generator,
            rows_actor=cfg.rollout_rows_actor, obs_transform=obs_transform,
            store_obs=cfg.store_rollout_obs,
            obs_dtype=rnad_lib.obs_storage_dtype(state.net, cfg),
            actor_dtype=rnad_lib.nets.DTYPES[cfg.rollout_actor_dtype])
        return state, rnad_lib.learn_step(state, packed, traj, alpha, cfg,
                                          group, batch_norm="per_rank")

    return train_step


def lane_slice(traj: engine.Trajectory, lanes: slice) -> engine.Trajectory:
    """The lanes ``lanes`` of a time-major "bma" trajectory."""
    buffer_lib.check_lane_major([traj])
    return engine.Trajectory(**{
        name: None if getattr(traj, name) is None
        else getattr(traj, name)[:, lanes].contiguous()
        for name in buffer_lib.LANE_FIELDS})


def make_shard_map_learn_step(tree: GameTree, cfg: RNaDConfig,
                              group: DataGroup):
    """Returns ``learn(state, traj, alpha) -> metrics``: one learner update
    (in place, as ``learn_step``) on this rank's lanes of the global
    trajectory ``traj``; equal to the one-device update up to summation
    order (module docstring).  The entry point for a learner update under
    explicit collectives, and the equivalence tests' target."""
    lanes = group.lanes(cfg.batch_size)
    packed = stepping.make_packed_tables(tree)

    def learn(state: rnad_lib.TrainState, traj: engine.Trajectory,
              alpha: float) -> Dict[str, torch.Tensor]:
        if traj.batch_size != cfg.batch_size:
            raise ValueError(f"the trajectory has {traj.batch_size} lanes, "
                             f"the config {cfg.batch_size}")
        return rnad_lib.learn_step(state, packed, lane_slice(traj, lanes),
                                   alpha, cfg, group, batch_norm="per_rank")

    return learn
