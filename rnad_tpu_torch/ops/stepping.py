"""Batched environment stepping over one packed state table.

Counterpart of ``rnad_tpu/ops/stepping.py``.  Everything a turn needs is
packed into ONE ``(S, D_pad)`` float32 table, so a turn reads one row per
lane (kernel K1 does exactly that) and the learner regathers observations
with one row lookup per turn (kernel K2):

    row layout (AA = A*A, T = max_transitions):
      [0    : 2AA)   row seat observation  [expected_value | legal]
      [2AA  : 4AA)   col seat observation  [-expected_value^T | legal^T]
      [4AA : 4AA+A)  row seat legal-action mask
      [4AA+A : 4AA+2A)  col seat legal-action mask
      [4AA + 2A + n*3T : ...)  per cell n = r*A + c:
                     [log_chance | child | value]

``D`` is padded to 128.  Child ids ride in the f32 table, exact for
S < 2^24.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..env.tree import GameTree
from . import lookup as lookup_lib

_NEG_INF = -1e30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def seat_observations(expected_value: torch.Tensor, legal: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE observation convention: the row player sees
    [expected_value | legal], the column player the negated, transposed
    matrix with transposed legality.  (N, 1, A, A) -> (N, 2, A, A) each."""
    row_obs = torch.cat([expected_value, legal], dim=1)
    col_obs = torch.cat([-expected_value, legal], dim=1).transpose(2, 3)
    return row_obs, col_obs


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """One-row-per-turn state table (see module docstring)."""

    rows: torch.Tensor  # (S, D_pad) float32
    max_actions: int
    max_transitions: int

    @property
    def obs_width(self) -> int:
        return 2 * self.max_actions * self.max_actions

    @property
    def mask_offset(self) -> int:
        return 2 * self.obs_width

    @property
    def trans_offset(self) -> int:
        return 2 * self.obs_width + 2 * self.max_actions


def make_packed_tables(tree: GameTree) -> PackedTables:
    A, T = tree.max_actions, tree.max_transitions
    S = tree.index.shape[0]
    if S >= 1 << 24:
        raise ValueError("packed tables require S < 2^24 (f32-exact indices)")
    AA = A * A

    row_obs4, col_obs4 = seat_observations(tree.expected_value, tree.legal)
    row_obs = row_obs4.reshape(S, 2 * AA)
    col_obs = col_obs4.reshape(S, 2 * AA)
    lg = tree.legal[:, 0]
    row_mask = lg[:, :, 0]  # (S, A): legal row actions
    col_mask = lg[:, 0, :]  # (S, A): legal col actions

    chance = tree.chance.permute(0, 2, 3, 1).reshape(S, AA, T)
    log_chance = torch.where(chance > 0,
                             torch.log(torch.clamp(chance, min=1e-30)),
                             torch.full_like(chance, _NEG_INF))
    child = tree.index.permute(0, 2, 3, 1).reshape(S, AA, T)
    value = tree.value.permute(0, 2, 3, 1).reshape(S, AA, T)
    trans = torch.cat([log_chance, child.to(torch.float32), value], -1)

    rows = torch.cat([row_obs, col_obs, row_mask, col_mask,
                      trans.reshape(S, AA * 3 * T)], -1)
    D = rows.shape[-1]
    D_pad = _round_up(D, 128)
    if D_pad != D:
        rows = torch.nn.functional.pad(rows, (0, D_pad - D))
    return PackedTables(rows=rows.contiguous(), max_actions=A,
                        max_transitions=T)


def lookup(packed: PackedTables, indices: torch.Tensor) -> torch.Tensor:
    """(N,) int32 state ids -> (N, D_pad) packed rows, through kernel K2 on
    the card (its plain version for CPU tensors)."""
    return lookup_lib.lookup(packed.rows, indices.to(torch.int32).contiguous())


def slice_observations(packed: PackedTables, rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed rows -> (row_obs, col_obs), each (N, 2, A, A)."""
    A = packed.max_actions
    W = packed.obs_width
    N = rows.shape[0]
    return (rows[:, :W].reshape(N, 2, A, A),
            rows[:, W:2 * W].reshape(N, 2, A, A))


def slice_action_masks(packed: PackedTables, rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mover's legal-action vectors for both seats: (N, A) each."""
    A = packed.max_actions
    off = packed.mask_offset
    return rows[:, off:off + A], rows[:, off + A:off + 2 * A]


def select_transition(packed: PackedTables, rows: torch.Tensor,
                      row_actions: torch.Tensor, col_actions: torch.Tensor,
                      g_chance: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint transition from already-gathered packed rows.

    Selects the (row, col) cell's [log_chance | child | value] triple,
    draws the chance action as ``argmax(log_chance + g_chance)`` (Gumbel
    noise ``g_chance`` (B, T); ties go to the lowest index), and emits the
    reward only on a transition into the absorbing state.  Returns
    (new_indices (B,) int32, rewards (B,))."""
    A, T = packed.max_actions, packed.max_transitions
    AA = A * A
    B = rows.shape[0]
    off = packed.trans_offset
    trans = rows[:, off:off + AA * 3 * T].reshape(B, AA, 3 * T)
    cell = (row_actions.long() * A + col_actions.long())
    sel = trans[torch.arange(B, device=rows.device), cell]  # (B, 3T)
    t = torch.argmax(sel[:, :T] + g_chance, dim=1, keepdim=True)
    new_indices = sel[:, T:2 * T].gather(1, t)[:, 0].to(torch.int32)
    value = sel[:, 2 * T:3 * T].gather(1, t)[:, 0]
    rewards = torch.where(new_indices == 0, value, torch.zeros_like(value))
    return new_indices, rewards
