"""Kernel K1: one whole rollout turn for every lane.

Counterpart of ``rnad_tpu/ops/pallas_turn.py::fused_turn``; the CUDA source
is ``csrc/fused_turn.cu``.  Per lane and turn: the packed row of the lane's
state, both seats' fused two-head MLP, the masked-softmax policy, a
Gumbel-max action per seat, the joint cell's transition triple, a
Gumbel-max chance draw, the child id and the reward on entering state 0.

The Gumbel noise is an input: ``g_act`` (2B, A), rows [0, B) for the row
seat and [B, 2B) for the column seat, and ``g_chance`` (B, T).  Given the
same noise, the turn is the same as ``rnad_tpu``'s gather-path turn
(``jax.random.categorical`` is ``argmax(logits + gumbel)``).

``fused_turn`` launches the kernel for CUDA tensors and runs
``fused_turn_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, stepping

MAX_ACTIONS = 8
MAX_TRANSITIONS = 8
SMEM_LIMIT_BYTES = 232_448  # what one Hopper block may use
TILE_LANES = 32  # lanes a block takes at a time (csrc/fused_turn.cu)
# rnad_fused_turn(table, S, D, idx, w0, b0, w1, b1, g_act, g_ch, new_idx,
#                 policy, actions, rewards, values, B, A, T, H, stream)
ARGTYPES = ((ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32)
            + (ctypes.c_void_p,) * 12 + (ctypes.c_int32,) * 4
            + (ctypes.c_void_p,))

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def turn_logits_plain(table, w0, b0, w1, b1, indices, *, A: int):
    """Both seats' forward of the plain version: the lanes' packed rows
    (B, D), masked logits (2B, A) (-1e30 on illegal actions), the legal
    masks (2B, A) and the values (2B,); seat-major rows."""
    obs_w = 2 * A * A
    mask_off = 2 * obs_w
    rows = table[indices.long()]
    obs = torch.cat([rows[:, :obs_w], rows[:, obs_w:2 * obs_w]], 0)
    mask = torch.cat([rows[:, mask_off:mask_off + A],
                      rows[:, mask_off + A:mask_off + 2 * A]], 0)
    h = torch.relu(obs @ w0 + b0)
    out = h @ w1 + b1  # (2B, A+1)
    ml = torch.where(mask > 0, out[:, :A], torch.full_like(mask, -1e30))
    return rows, ml, mask, out[:, A]


def fused_turn_plain(table, w0, b0, w1, b1, indices, g_act, g_chance, *,
                     A: int, T: int) -> _Outputs:
    """Plain version, op by op after the TPU kernel's body."""
    B = indices.shape[0]
    rows, ml, mask, values = turn_logits_plain(table, w0, b0, w1, b1,
                                               indices, A=A)
    policy = torch.where(mask > 0, torch.softmax(ml, dim=1),
                         torch.zeros_like(mask))
    actions = torch.argmax(ml + g_act, dim=1).to(torch.int32)
    packed = stepping.PackedTables(rows=table, max_actions=A,
                                   max_transitions=T)
    new_idx, rewards = stepping.select_transition(
        packed, rows, actions[:B], actions[B:], g_chance)
    return (new_idx, policy.reshape(2, B, A), actions.reshape(2, B), rewards,
            values.reshape(2, B))


def operations(A: int, H: int) -> int:
    """Arithmetic operations one (lane, seat) row needs, an FMA counting
    two: the first layer (din * H) and the second, whose fused W1 is
    block-diagonal (``nets.mlp_fused_weights``): the policy half's W units
    feed the A logits and the value half's the value, W * (A + 1) in all.
    The kernel also multiplies the zeros, as the TPU kernel does; the bound
    counts only what the function needs.  The epilogue's few dozen
    operations are left out."""
    return 2 * (2 * A * A * H + H // 2 * (A + 1))


def smem_bytes(A: int, H: int) -> int:
    """Shared memory the kernel's layout takes at (A, H); builds the
    library on first use (the card's machine only)."""
    return _build.entry("fused_turn", "rnad_fused_turn_smem_bytes",
                        (ctypes.c_int32,) * 2, ctypes.c_size_t)(A, H)


def fits(A: int, H: int) -> bool:
    """Whether the kernel takes hidden width H (2W) at A actions: its
    weights, zero-padded to 64 units, and a tile's staged inputs fit in
    one block's shared memory."""
    return smem_bytes(A, H) <= SMEM_LIMIT_BYTES


def _check_args(table, w0, b0, w1, b1, indices, g_act, g_chance, A, T):
    B = indices.shape[0]
    din = 2 * A * A
    H = w0.shape[-1]
    want = {"table": (table, (table.shape[0], table.shape[-1])),
            "w0": (w0, (din, H)), "b0": (b0, (H,)), "w1": (w1, (H, A + 1)),
            "b1": (b1, (A + 1,)), "indices": (indices, (B,)),
            "g_act": (g_act, (2 * B, A)), "g_chance": (g_chance, (B, T))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_turn: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != table.device:
            raise ValueError(f"fused_turn: {name} is on {t.device}, the "
                             f"table on {table.device}")
        want_dtype = torch.int32 if name == "indices" else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"fused_turn: {name} is {t.dtype}, want "
                            f"{want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_turn: {name} is not contiguous")
    if table.dim() != 2 or table.shape[1] < 2 * din + 2 * A + 3 * T * A * A:
        raise ValueError(f"fused_turn: table {tuple(table.shape)} is not a "
                         f"packed table for A={A}, T={T}")
    if not 1 <= A <= MAX_ACTIONS or not 1 <= T <= MAX_TRANSITIONS:
        raise ValueError(f"fused_turn supports A <= {MAX_ACTIONS} and T <= "
                         f"{MAX_TRANSITIONS}, got A={A}, T={T}")
    if table.shape[0] >= 1 << 24:
        raise ValueError("fused_turn decodes child ids from f32: S < 2^24")


def fused_turn(table: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
               w1: torch.Tensor, b1: torch.Tensor, indices: torch.Tensor,
               g_act: torch.Tensor, g_chance: torch.Tensor, *, A: int,
               T: int) -> _Outputs:
    """One turn for all lanes.  ``table`` is the (S, D_pad) packed table,
    (w0, b0, w1, b1) the fused MLP of ``nets.mlp_fused_weights``.

    Returns (new_indices (B,) int32, policy (2, B, A), actions (2, B)
    int32, rewards (B,), values (2, B))."""
    _check_args(table, w0, b0, w1, b1, indices, g_act, g_chance, A, T)
    if table.device.type == "cpu":
        return fused_turn_plain(table, w0, b0, w1, b1, indices, g_act,
                                g_chance, A=A, T=T)
    if table.device.type != "cuda":
        raise ValueError(f"fused_turn runs on cuda or cpu, not {table.device}")
    H = w0.shape[1]
    if not fits(A, H):
        raise ValueError(f"fused_turn keeps the weights in shared memory: "
                         f"{smem_bytes(A, H)} bytes at A={A}, 2W={H} exceed "
                         f"{SMEM_LIMIT_BYTES}")
    fn = _build.entry("fused_turn", "rnad_fused_turn", ARGTYPES)
    S, D = table.shape
    B = indices.shape[0]
    dev = table.device
    new_idx = torch.empty((B,), dtype=torch.int32, device=dev)
    policy = torch.empty((2, B, A), dtype=torch.float32, device=dev)
    actions = torch.empty((2, B), dtype=torch.int32, device=dev)
    rewards = torch.empty((B,), dtype=torch.float32, device=dev)
    values = torch.empty((2, B), dtype=torch.float32, device=dev)
    if B == 0:
        return new_idx, policy, actions, rewards, values
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), S, D, indices.data_ptr(), w0.data_ptr(),
                 b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 g_act.data_ptr(), g_chance.data_ptr(), new_idx.data_ptr(),
                 policy.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
                 values.data_ptr(), B, A, T, H, stream)
    _build.check("fused_turn", "rnad_fused_turn", err)
    fused_turn.launches += 1
    return new_idx, policy, actions, rewards, values


fused_turn.launches = 0  # kernel launches (CUDA tensors only)
