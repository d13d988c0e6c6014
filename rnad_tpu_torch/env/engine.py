"""Batched rollout engine: every turn is one fused-turn kernel launch.

Counterpart of ``rnad_tpu/env/engine.py`` (the ``"bma"`` trajectory layout,
``rollout_from``, ``trajectory_observations``, ``episode_returns``).  The
absorbing-state convention (terminated lanes self-loop at index 0 with
reward 0) means no masking mid-rollout; validity is ``indices != 0``.

A ``Trajectory`` stores only state indices, the mover's behavior policy,
sampled action ids, rewards and value estimates.  Observations are pure
functions of the state index, so the learner regathers them from the packed
table (``trajectory_observations``, kernel K2 on the card), as ``rnad_tpu``
does with ``store_rollout_obs=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..models import nets
from ..ops import fused_turn as fused_turn_lib
from ..ops import stepping
from .tree import GameTree

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class Trajectory:
    """Time-major batch of trajectories; T = 2 * number of turns.

    Half-step t has mover t % 2 (0 = row, 1 = col); both half-steps of a
    turn share the state index.  Rewards are from the row player's
    perspective and nonzero only on col half-steps that enter the absorbing
    state."""

    indices: torch.Tensor  # (T, B) int32, state id at each half-step
    policy: torch.Tensor  # (T, B, A) f32, mover's behavior policy mu
    actions: torch.Tensor  # (T, B) int32, sampled action ids
    rewards: torch.Tensor  # (T, B) f32, row-player reward (zero-sum)
    values: torch.Tensor  # (T, B) f32, actor value estimates (mover's POV)

    @property
    def num_half_steps(self) -> int:
        return self.indices.shape[0]

    @property
    def batch_size(self) -> int:
        return self.indices.shape[1]

    @property
    def num_actions(self) -> int:
        return self.policy.shape[-1]

    @property
    def turns(self) -> torch.Tensor:
        """(T, B) mover ids from the half-step parity."""
        T, B = self.indices.shape
        t = torch.arange(T, dtype=torch.int32, device=self.indices.device) % 2
        return t[:, None].expand(T, B)

    def actions_oh(self) -> torch.Tensor:
        a = torch.arange(self.num_actions, device=self.actions.device)
        return (self.actions[..., None] == a).to(self.policy.dtype)

    def valid(self) -> torch.Tensor:
        """(T, B) 1.0 where the half-step belongs to a live episode."""
        return (self.indices != 0).to(torch.float32)


def gumbel(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1) as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


def turn_noise(batch_size: int, A: int, T: int,
               generator: Optional[torch.Generator], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One turn's noise: ``g_act`` (2B, A), then ``g_chance`` drawn as
    (T, B) and transposed to (B, T), the shapes and order of the TPU
    kernel (``rollout_fused``)."""
    g_act = gumbel((2 * batch_size, A), generator, device)
    g_ch = gumbel((T, batch_size), generator, device).t().contiguous()
    return g_act, g_ch


def trajectory_observations(packed: stepping.PackedTables, traj: Trajectory
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-derives per-half-step observations (T, B, 2, A, A) and mover
    legal masks (T, B, A) with one lookup of the (T/2)*B turn states; even
    half-steps get the row seat's view, odd ones the col seat's."""
    T, B = traj.indices.shape
    n_turns = T // 2
    rows = stepping.lookup(packed, traj.indices[0::2].reshape(-1))
    row_obs, col_obs = stepping.slice_observations(packed, rows)
    row_mask, col_mask = stepping.slice_action_masks(packed, rows)

    def pair(r, c):
        return torch.stack(
            [r.reshape((n_turns, B) + r.shape[1:]),
             c.reshape((n_turns, B) + c.shape[1:])], dim=1
        ).reshape((T, B) + r.shape[1:])

    return pair(row_obs, col_obs), pair(row_mask, col_mask)


@torch.no_grad()
def rollout_from(tree: GameTree, packed: stepping.PackedTables,
                 net: nets.MLP, init_indices: torch.Tensor,
                 num_turns: Optional[int] = None, *,
                 noise: Optional[Sequence[Tuple[torch.Tensor,
                                                torch.Tensor]]] = None,
                 generator: Optional[torch.Generator] = None) -> Trajectory:
    """Plays ``num_turns`` turns (default ``tree.max_depth``) from the
    per-lane states ``init_indices`` (B,) under ``net``'s policy.

    ``noise`` gives each turn's ``(g_act (2B, A), g_chance (B, T))``; if it
    is None they are drawn from ``generator`` on the tree's device."""
    if num_turns is None:
        num_turns = tree.max_depth
    A, T = packed.max_actions, packed.max_transitions
    B = init_indices.shape[0]
    device = packed.rows.device
    w0, b0, w1, b1 = (w.detach().contiguous()
                      for w in nets.mlp_fused_weights(net))
    indices = init_indices.to(device=device, dtype=torch.int32).contiguous()
    recs = []
    for t in range(num_turns):
        if noise is None:
            g_act, g_ch = turn_noise(B, A, T, generator, device)
        else:
            g_act, g_ch = (g.to(device=device, dtype=torch.float32)
                           .contiguous() for g in noise[t])
        new_idx, policy, actions, rewards, values = fused_turn_lib.fused_turn(
            packed.rows, w0, b0, w1, b1, indices, g_act, g_ch, A=A, T=T)
        recs.append((torch.stack([indices, indices]), policy, actions,
                     torch.stack([torch.zeros_like(rewards), rewards]),
                     values))
        indices = new_idx
    cat = lambda i: torch.cat([r[i] for r in recs], 0)
    return Trajectory(indices=cat(0), policy=cat(1), actions=cat(2),
                      rewards=cat(3), values=cat(4))


def episode_returns(traj: Trajectory) -> torch.Tensor:
    """(B,) row-player terminal reward of each episode."""
    return traj.rewards.sum(dim=0)
