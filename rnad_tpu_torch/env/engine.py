"""Batched rollout engine: a turn is one fused-turn kernel launch (K1) for
the MLP, or the generic turn for any net.

Counterpart of ``rnad_tpu/env/engine.py`` (the ``"bma"`` trajectory layout,
``rollout_from``, ``rollout_tabular``, ``trajectory_observations``,
``episode_returns``).  The
absorbing-state convention (terminated lanes self-loop at index 0 with
reward 0) means no masking mid-rollout; validity is ``indices != 0``.
Both turns take the same noise and, given equal logits, play the same
episodes.

A ``Trajectory`` stores state indices, the mover's behavior policy,
sampled action ids, rewards and value estimates, and with ``store_obs``
(``RNaDConfig.store_rollout_obs``, on by default) each half-step's
observation (``Trajectory.obs``): K1 copies the raw ones out of the rows it
stages anyway, the generic turn keeps the batch it fed the net, and the
learner skips its regather.  Raw observations are pure functions of the
state index, so without them the learner regathers them from the packed
table (``trajectory_observations``, kernel K2 on the card).  Under an
observation transform (``ops/obs_transform.py``) the rollout always stores
each half-step's lifted, noisy observation: the noise is no function of
the state, and the learner must read the bits the actor saw.

``lane_chunks``, as in ``rnad_tpu``, rolls the lanes out as sequential
sub-batches (bounding the peak memory of a turn's intermediates).  The
behavior policy is recorded (T, B, A) only: ``rnad_tpu``'s (T, A, B)
record feeds its batch-minor learner, which the port does not run.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models import common, nets
from ..ops import equinet as equinet_lib
from ..ops import fused_turn as fused_turn_lib
from ..ops import stepping
from ..ops.obs_transform import ObsTransform
from ..utils import timing
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
    policy: torch.Tensor  # (T, B, A) f32, the mover's behavior policy mu
    actions: torch.Tensor  # (T, B) int32, sampled action ids
    rewards: torch.Tensor  # (T, B) f32, row-player reward (zero-sum)
    values: torch.Tensor  # (T, B) f32, actor value estimates (mover's POV)
    # (T, B, C, A, A) the mover's observation where stored: raw (C = 2) or
    # lifted (C = lifted channels + 1); channel 1 is the legal matrix in
    # both, so the mover's mask is obs[..., 1, :, 0]
    obs: Optional[torch.Tensor] = None
    # ``rnad_tpu``'s name of the policy record's layout, always (T, B, A);
    # a class constant, so not a field
    policy_layout: ClassVar[str] = "bma"

    @property
    def num_half_steps(self) -> int:
        return self.indices.shape[0]

    @property
    def batch_size(self) -> int:
        return self.indices.shape[1]

    @property
    def num_actions(self) -> int:
        return self.policy.shape[-1]

    def policy_bma(self) -> torch.Tensor:
        """The behavior policy (T, B, A), ``policy`` itself, under
        ``rnad_tpu``'s name, which the benchmark's harness reads."""
        return self.policy

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
               generator: Optional[torch.Generator], device,
               channels: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """One turn's noise: ``g_act`` (2B, A), then ``g_chance`` drawn as
    (T, B) and transposed to (B, T), the shapes and order of the TPU
    kernel (``rollout_fused``).  With ``channels`` (an observation
    transform's lifted channel count) the unit Gaussian ``eps`` (2B,
    channels, A, A) of both seats' lifts follows."""
    g_act = gumbel((2 * batch_size, A), generator, device)
    g_ch = gumbel((T, batch_size), generator, device).t().contiguous()
    if channels is None:
        return g_act, g_ch
    eps = torch.randn((2 * batch_size, channels, A, A), generator=generator,
                      device=device, dtype=torch.float32)
    return g_act, g_ch, eps


def local_noise(noise: Sequence[torch.Tensor], lanes: slice,
                batch_size: int) -> Tuple[torch.Tensor, ...]:
    """The lanes ``lanes`` of one turn's noise for ``batch_size`` lanes:
    ``g_act`` (2B, A) and the lift's ``eps`` (2B, C, A, A) are seat-major,
    so the lanes are two row ranges, one a seat block; ``g_chance`` (B, T)
    is one."""
    seat_rows = lambda x: torch.cat([x[lanes], x[batch_size:][lanes]])
    g_act, g_ch, *eps = noise
    return (seat_rows(g_act), g_ch[lanes]) + tuple(seat_rows(e)
                                                   for e in eps)


def trajectory_observations(packed: stepping.PackedTables, traj: Trajectory
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-half-step observations (T, B, C, A, A) and mover legal masks
    (T, B, A): the stored ones where the trajectory holds them, else
    re-derived (C = 2) with one lookup of the (T/2)*B turn states; even
    half-steps get the row seat's view, odd ones the col seat's."""
    if traj.obs is not None:
        return traj.obs, traj.obs[..., 1, :, 0].float()
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


def uses_fused_turn(net: nn.Module, mode: str = "auto",
                    transform: bool = False,
                    actor_dtype: torch.dtype = torch.float32) -> bool:
    """Resolves ``RNaDConfig.rollout_rows_actor`` as ``rnad_tpu``'s
    ``resolve_rows_actor`` does: "auto" takes kernel K1 exactly where it
    exists (the depth-1 float32 MLP on raw observations, on the card at a
    width whose weights K1 holds in shared memory, or on the CPU) and the
    generic turn for every other net or under an observation
    ``transform``; "off" takes the generic turn; "on" with another net (a
    deeper MLP, whose hidden layers K1's packing has no place for, and a
    bfloat16 MLP included: K1 computes in float32) raises
    ``make_mlp_rows_actor``'s error, under a transform rnad_tpu's error,
    and on the card at too wide an MLP K1 raises.

    ``actor_dtype`` (``RNaDConfig.rollout_actor_dtype``) is K1's operand
    type; like rnad_tpu, only the K1 route reads it.  An MLP too wide for
    the bfloat16 variant raises under "auto" too: the generic turn would
    compute other (float32) values."""
    fusable = (isinstance(net, nets.MLP) and net.depth == 1
               and net.dtype == torch.float32)
    if mode == "off":
        return False
    if transform:
        # K1 reads raw packed rows, bypassing the observation path the
        # transform lives on
        if mode == "on":
            raise ValueError(
                "rollout_rows_actor='on' is incompatible with an active "
                "obs_transform (the seat-fused packing bypasses the "
                "observation path); use 'auto' or 'off'")
        return False
    if mode == "on":
        if not isinstance(net, nets.MLP):
            raise ValueError(
                f"make_mlp_rows_actor requires an MLP net, got "
                f"{type(net).__name__}; use the generic actor_fn path")
        if net.depth != 1:
            raise ValueError(
                f"make_mlp_rows_actor supports depth=1 MLPs only (got depth="
                f"{net.depth}); mlp_seat_fused_weights cannot express hidden "
                f"layers")
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
    if not on_card or fused_turn_lib.fits(net.max_actions, 2 * net.width,
                                          actor_dtype):
        return True
    if actor_dtype != torch.float32:
        raise ValueError(
            f"rollout_actor_dtype={str(actor_dtype).split('.')[-1]}: K1's "
            f"{str(actor_dtype).split('.')[-1]}-operand variant cannot hold "
            f"an MLP of width {net.width} at A={net.max_actions} in shared "
            f"memory, and the generic turn computes in float32")
    return False


def generic_turn(packed: stepping.PackedTables, net: nn.Module,
                 indices: torch.Tensor, g_act: torch.Tensor,
                 g_chance: torch.Tensor,
                 obs_transform: Optional[ObsTransform] = None,
                 eps: Optional[torch.Tensor] = None,
                 params: Optional[torch.Tensor] = None):
    """One turn for any net (``rnad_tpu``'s generic turn): the lanes'
    packed rows (K2), both seats' observations as one (2B, 2, A, A) batch
    (lifted with the noise ``eps`` under ``obs_transform``) through ``net``
    (for a solver EquiNet, one K3 launch; for a plain bf16 EquiNet on the
    card, then one K4 launch on ``params``, its ``equinet.pack``: see
    ``equinet.forward_no_grad``), the masked policy, Gumbel-max actions
    ``argmax(masked logits + g_act)`` and the transition with
    ``g_chance``.  Returns what ``fused_turn`` returns, then the (2B, C, A,
    A) observations the net saw."""
    A = packed.max_actions
    B = indices.shape[0]
    rows = stepping.lookup(packed, indices)
    row_obs, col_obs = stepping.slice_observations(packed, rows)
    obs = torch.cat([row_obs, col_obs], dim=0)
    if obs_transform is not None:
        obs = obs_transform.apply(obs, eps)
    with timing.span("rnad.rollout.forward"):
        logits, values = equinet_lib.forward_no_grad(
            net, obs, params, span="rnad.rollout.forward.fused")
    row_mask, col_mask = stepping.slice_action_masks(packed, rows)
    legal = torch.cat([row_mask, col_mask], dim=0)  # (2B, A)
    policy = common.masked_policy(logits, legal).reshape(2, B, A)
    actions = torch.argmax(common.masked_logits(logits, legal) + g_act,
                           dim=1).to(torch.int32)
    new_idx, rewards = stepping.select_transition(
        packed, rows, actions[:B], actions[B:], g_chance)
    return (new_idx, policy, actions.reshape(2, B), rewards,
            values.reshape(2, B), obs)


@torch.no_grad()
def rollout_from(tree: GameTree, packed: stepping.PackedTables,
                 net: nn.Module, init_indices: torch.Tensor,
                 num_turns: Optional[int] = None, *,
                 noise: Optional[Sequence[Tuple[torch.Tensor,
                                                torch.Tensor]]] = None,
                 generator: Optional[torch.Generator] = None,
                 rows_actor: str = "auto",
                 obs_transform: Optional[ObsTransform] = None,
                 store_obs: bool = False,
                 obs_dtype: torch.dtype = torch.float32,
                 lane_chunks: int = 1,
                 actor_dtype: torch.dtype = torch.float32) -> Trajectory:
    """Plays ``num_turns`` turns (default ``tree.max_depth``) from the
    per-lane states ``init_indices`` (B,) under ``net``'s policy, each turn
    through kernel K1 (its weights cast once to ``actor_dtype``, its
    operand type) or the generic turn as ``uses_fused_turn`` resolves
    ``rows_actor``.  A ConvNet acts on its BatchNorm running averages.

    ``noise`` gives each turn's ``(g_act (2B, A), g_chance (B, T))``, and
    under ``obs_transform`` also the lift's ``eps`` (2B, C, A, A); if it is
    None they are drawn from ``generator`` on the tree's device
    (``turn_noise``).

    ``store_obs`` records each half-step's observation in ``obs_dtype``
    (``Trajectory.obs``), sparing the learner its regather: K1 writes the
    raw ones as an output, the generic turn keeps the batch it fed the
    net.  Under ``obs_transform`` the lifted observations the net saw are
    stored whatever ``store_obs`` says.

    ``lane_chunks`` k > 1 rolls the lanes out as k sequential sub-batches
    of B / k lanes (B must divide), each through every turn before the
    next starts, and stitches the trajectory back chunk-major, as
    ``rnad_tpu``'s ``rollout_from(lane_chunks=k)`` does; it bounds the
    peak memory of a turn's intermediates.  Given ``noise``, chunk c takes
    its own lanes' columns of each turn's full-batch noise
    (``local_noise``), so the chunked rollout plays the whole rollout's
    episodes.  Given a ``generator``, each chunk draws its own turns'
    noise in chunk order: like ``rnad_tpu``'s per-chunk keys, a chunked
    run then plays other, equally valid episodes than an unchunked one."""
    if num_turns is None:
        num_turns = tree.max_depth
    B = init_indices.shape[0]
    if lane_chunks < 1:
        raise ValueError(f"lane_chunks must be >= 1, got {lane_chunks}")
    if B % lane_chunks:
        raise ValueError(f"batch {B} not divisible by {lane_chunks}")
    A, T = packed.max_actions, packed.max_transitions
    device = packed.rows.device
    channels = None if obs_transform is None else obs_transform.channels
    store = store_obs or obs_transform is not None
    if uses_fused_turn(net, rows_actor, obs_transform is not None,
                       actor_dtype):
        w0, b0, w1, b1 = [w.detach() for w in nets.mlp_fused_weights(net)]
        weights = [w0.to(actor_dtype).contiguous(), b0.contiguous(),
                   w1.to(actor_dtype).contiguous(), b1.contiguous()]
        turn = lambda idx, g_act, g_ch: fused_turn_lib.fused_turn(
            packed.rows, *weights, idx, g_act, g_ch, A=A, T=T,
            store_obs=store) + ((None,) if not store else ())
    else:
        params = equinet_lib.packed_params(net)  # the turns' K4 weights
        turn = lambda idx, g_act, g_ch, eps=None: generic_turn(
            packed, net, idx, g_act, g_ch, obs_transform, eps, params)
    init = init_indices.to(device=device, dtype=torch.int32)
    b = B // lane_chunks
    recs = []  # (chunk, turn) -> the turn's record of the chunk's lanes
    for c in range(lane_chunks):
        lanes = slice(c * b, (c + 1) * b)
        indices = init[lanes].contiguous()
        recs.append([])
        for t in range(num_turns):
            if noise is None:
                step_noise = turn_noise(b, A, T, generator, device, channels)
            else:
                step_noise = noise[t] if lane_chunks == 1 else local_noise(
                    noise[t], lanes, B)
                step_noise = [g.to(device=device, dtype=torch.float32)
                              .contiguous() for g in step_noise]
            new_idx, policy, actions, rewards, values, obs = turn(
                indices, *step_noise)
            recs[c].append((
                torch.stack([indices, indices]), policy, actions,
                torch.stack([torch.zeros_like(rewards), rewards]), values,
                obs.to(obs_dtype).reshape((2, b) + obs.shape[-3:])
                if store else None))
            indices = new_idx

    def cat(i):  # the turns along time, then the chunks along the lanes
        parts = [torch.cat([r[i] for r in chunk], 0) for chunk in recs]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 1)

    return Trajectory(indices=cat(0), policy=cat(1), actions=cat(2),
                      rewards=cat(3), values=cat(4),
                      obs=cat(5) if store else None)


def tabular_noise(batch_size: int, A: int, T: int,
                  generator: Optional[torch.Generator], device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One turn's noise of ``rollout_tabular``: Gumbel ``g_row`` (B, A),
    ``g_col`` (B, A) and ``g_chance`` (B, T), drawn in that order."""
    return (gumbel((batch_size, A), generator, device),
            gumbel((batch_size, A), generator, device),
            gumbel((batch_size, T), generator, device))


@torch.no_grad()
def rollout_tabular(tree: GameTree, joint_policy: torch.Tensor,
                    batch_size: int, num_turns: Optional[int] = None, *,
                    noise: Optional[Sequence[Tuple[torch.Tensor, ...]]]
                    = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Trajectory:
    """``batch_size`` episodes from the root under a per-node joint policy
    (S, 2A) (``rnad_tpu``'s ``rollout_tabular``): each seat plays
    ``argmax(log p + g)`` over its legal actions (log 0 = -1e30), the
    chance outcome is ``argmax(log chance + g_chance)`` of the chosen cell,
    and the values are the stored exact node values (the row seat's v,
    the column seat's -v).  Rolling out ``tree.solution`` is the oracle
    check: the mean return is the root value.  ``noise`` gives each turn's
    ``tabular_noise``; if it is None it is drawn from ``generator`` on the
    tree's device."""
    if num_turns is None:
        num_turns = tree.max_depth
    A, T = tree.max_actions, tree.max_transitions
    B = batch_size
    device = tree.device
    log = lambda p: torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)),
                                torch.full_like(p, -1e30))
    norm = lambda p: p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    indices = torch.ones((B,), dtype=torch.int32, device=device)
    recs = []
    for t in range(num_turns):
        g_row, g_col, g_ch = (
            tabular_noise(B, A, T, generator, device) if noise is None else
            [g.to(device=device, dtype=torch.float32) for g in noise[t]])
        idx = indices.long()
        legal = tree.legal[idx, 0]  # (B, A, A)
        pi = joint_policy[idx]
        zero = torch.zeros((), dtype=pi.dtype, device=device)
        pi_row = torch.where(legal[:, :, 0] > 0, pi[:, :A], zero)
        pi_col = torch.where(legal[:, 0, :] > 0, pi[:, A:], zero)
        row_a = torch.argmax(log(pi_row) + g_row, dim=1)
        col_a = torch.argmax(log(pi_col) + g_col, dim=1)
        cell = lambda x: x[idx, :, row_a, col_a]  # (B, T)
        chance_a = torch.argmax(log(cell(tree.chance)) + g_ch, dim=1,
                                keepdim=True)
        new_idx = cell(tree.index).gather(1, chance_a)[:, 0].to(torch.int32)
        value = cell(tree.value).gather(1, chance_a)[:, 0]
        rewards = torch.where(new_idx == 0, value, torch.zeros_like(value))
        v = tree.root_value[idx, 0]
        recs.append((torch.stack([indices, indices]),
                     torch.stack([norm(pi_row), norm(pi_col)]),
                     torch.stack([row_a, col_a]).to(torch.int32),
                     torch.stack([torch.zeros_like(rewards), rewards]),
                     torch.stack([v, -v])))
        indices = new_idx
    cat = lambda i: torch.cat([r[i] for r in recs], 0)
    return Trajectory(indices=cat(0), policy=cat(1), actions=cat(2),
                      rewards=cat(3), values=cat(4))


def episode_returns(traj: Trajectory) -> torch.Tensor:
    """(B,) row-player terminal reward of each episode."""
    return traj.rewards.sum(dim=0)
