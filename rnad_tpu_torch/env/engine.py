"""Batched rollout engine: a turn is one fused-turn kernel launch (K1) for
the MLP, or the generic turn for any net.

Counterpart of ``rnad_tpu/env/engine.py`` (the ``"bma"`` trajectory layout,
``rollout_from``, ``trajectory_observations``, ``episode_returns``).  The
absorbing-state convention (terminated lanes self-loop at index 0 with
reward 0) means no masking mid-rollout; validity is ``indices != 0``.
Both turns take the same noise and, given equal logits, play the same
episodes.

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
from torch import nn

from ..models import common, nets
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


def uses_fused_turn(net: nn.Module, mode: str = "auto") -> bool:
    """Resolves ``RNaDConfig.rollout_rows_actor`` as ``rnad_tpu``'s
    ``resolve_rows_actor`` does: "auto" takes kernel K1 exactly where it
    exists (the depth-1 float32 MLP, on the card at a width whose weights
    K1 holds in shared memory, or on the CPU) and the generic turn for
    every other net; "off" takes the generic turn; "on" with another net
    (a bfloat16 MLP included: K1 computes in float32) raises
    ``make_mlp_rows_actor``'s error, and on the card at too wide an MLP K1
    raises."""
    fusable = isinstance(net, nets.MLP) and net.dtype == torch.float32
    if mode == "off":
        return False
    if mode == "on":
        if not isinstance(net, nets.MLP):
            raise ValueError(
                f"make_mlp_rows_actor requires an MLP net, got "
                f"{type(net).__name__}; use the generic actor_fn path")
        if not fusable:
            raise ValueError(
                f"make_mlp_rows_actor computes in float32; net dtype "
                f"{str(net.dtype).split('.')[-1]} would silently diverge "
                f"from the generic actor path")
        return True
    if mode != "auto":
        raise ValueError(f"unknown rollout_rows_actor mode {mode!r}")
    if not fusable:
        return False
    on_card = next(net.parameters()).device.type == "cuda"
    return not on_card or fused_turn_lib.fits(net.max_actions, 2 * net.width)


def generic_turn(packed: stepping.PackedTables, net: nn.Module,
                 indices: torch.Tensor, g_act: torch.Tensor,
                 g_chance: torch.Tensor):
    """One turn for any net (``rnad_tpu``'s generic turn): the lanes'
    packed rows (K2), both seats' observations as one (2B, 2, A, A) batch
    through ``net`` (for a solver EquiNet, one K3 launch), the masked
    policy, Gumbel-max actions ``argmax(masked logits + g_act)`` and the
    transition with ``g_chance``.  Returns what ``fused_turn`` returns."""
    A = packed.max_actions
    B = indices.shape[0]
    rows = stepping.lookup(packed, indices)
    row_obs, col_obs = stepping.slice_observations(packed, rows)
    logits, values = net(torch.cat([row_obs, col_obs], dim=0))
    row_mask, col_mask = stepping.slice_action_masks(packed, rows)
    legal = torch.cat([row_mask, col_mask], dim=0)  # (2B, A)
    policy = common.masked_policy(logits, legal).reshape(2, B, A)
    actions = torch.argmax(common.masked_logits(logits, legal) + g_act,
                           dim=1).to(torch.int32)
    new_idx, rewards = stepping.select_transition(
        packed, rows, actions[:B], actions[B:], g_chance)
    return (new_idx, policy, actions.reshape(2, B), rewards,
            values.reshape(2, B))


@torch.no_grad()
def rollout_from(tree: GameTree, packed: stepping.PackedTables,
                 net: nn.Module, init_indices: torch.Tensor,
                 num_turns: Optional[int] = None, *,
                 noise: Optional[Sequence[Tuple[torch.Tensor,
                                                torch.Tensor]]] = None,
                 generator: Optional[torch.Generator] = None,
                 rows_actor: str = "auto") -> Trajectory:
    """Plays ``num_turns`` turns (default ``tree.max_depth``) from the
    per-lane states ``init_indices`` (B,) under ``net``'s policy, each turn
    through kernel K1 or the generic turn as ``uses_fused_turn`` resolves
    ``rows_actor``.

    ``noise`` gives each turn's ``(g_act (2B, A), g_chance (B, T))``; if it
    is None they are drawn from ``generator`` on the tree's device."""
    if num_turns is None:
        num_turns = tree.max_depth
    A, T = packed.max_actions, packed.max_transitions
    B = init_indices.shape[0]
    device = packed.rows.device
    if uses_fused_turn(net, rows_actor):
        weights = [w.detach().contiguous()
                   for w in nets.mlp_fused_weights(net)]
        turn = lambda idx, g_act, g_ch: fused_turn_lib.fused_turn(
            packed.rows, *weights, idx, g_act, g_ch, A=A, T=T)
    else:
        turn = lambda idx, g_act, g_ch: generic_turn(packed, net, idx, g_act,
                                                     g_ch)
    indices = init_indices.to(device=device, dtype=torch.int32).contiguous()
    recs = []
    for t in range(num_turns):
        if noise is None:
            g_act, g_ch = turn_noise(B, A, T, generator, device)
        else:
            g_act, g_ch = (g.to(device=device, dtype=torch.float32)
                           .contiguous() for g in noise[t])
        new_idx, policy, actions, rewards, values = turn(indices, g_act, g_ch)
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
