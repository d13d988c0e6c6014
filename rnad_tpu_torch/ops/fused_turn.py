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

The weights W0 and W1 come in float32 or, for the bf16-operand variant
(``rnad_tpu``'s rows-actor with ``compute_dtype=bfloat16``), in bfloat16:
the row and the hidden activation are then rounded to bfloat16 too, the
products and sums stay float32, and so do the biases.  The float32
variant runs on the CUDA cores; the bf16 variant's first layer runs on the
tensor cores (``mma.sync`` m16n8k16), its second on the CUDA cores.

With ``store_obs`` the turn also returns the lanes' observations, the
counterpart of ``rnad_tpu``'s rows-actor rollout under ``store_obs=True``:
(2, B, 2, A, A) float32, seat-major, each lane's two seat views of its
packed row, copied out of the tile the kernel stages anyway.

``fused_turn`` launches the kernel for CUDA tensors and runs
``fused_turn_plain`` only for CPU tensors.  ``fused_turn.launches`` counts
the float32 variant's launches, ``fused_turn.launches_bf16`` the bf16
variant's.
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
#                 policy, actions, rewards, values, obs, B, A, T, H, bf16,
#                 stream); obs may be null
ARGTYPES = ((ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32)
            + (ctypes.c_void_p,) * 13 + (ctypes.c_int32,) * 5
            + (ctypes.c_void_p,))
OPERAND_DTYPES = (torch.float32, torch.bfloat16)

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


ROUNDED = ("row", "hidden")  # the bf16 variant's operands


def _seats_plain(table, w0, b0, indices, A: int, rounded=ROUNDED):
    """The lanes' packed rows (B, D), both seats' legal masks (2B, A),
    first-layer inputs (2B, din), pre-activations and hidden activations
    (2B, H), seat-major rows.  With bfloat16 weights the operands named in
    ``rounded`` (the row, the hidden activation) are rounded to bfloat16
    and multiplied in float32 (exact products; keep TF32 off)."""
    obs_w = 2 * A * A
    mask_off = 2 * obs_w
    rows = table[indices.long()]
    obs = torch.cat([rows[:, :obs_w], rows[:, obs_w:2 * obs_w]], 0)
    mask = torch.cat([rows[:, mask_off:mask_off + A],
                      rows[:, mask_off + A:mask_off + 2 * A]], 0)
    # the operands in the weights' type, the products and sums in float32
    operand = lambda x, name: (x.to(w0.dtype).float() if name in rounded
                               else x)
    x = operand(obs, "row")
    pre = x @ w0.float() + b0
    return rows, mask, x, pre, operand(torch.relu(pre), "hidden")


def turn_logits_plain(table, w0, b0, w1, b1, indices, *, A: int,
                      rounded=ROUNDED):
    """Both seats' forward of the plain version: the lanes' packed rows
    (B, D), masked logits (2B, A) (-1e30 on illegal actions), the legal
    masks (2B, A) and the values (2B,); seat-major rows.  ``rounded`` as
    in ``_seats_plain`` (a control leaves an operand unrounded)."""
    rows, mask, _, _, h = _seats_plain(table, w0, b0, indices, A, rounded)
    out = h @ w1.float() + b1  # (2B, A+1)
    ml = torch.where(mask > 0, out[:, :A], torch.full_like(mask, -1e30))
    return rows, ml, mask, out[:, A]


def bf16_band(table, w0, b0, w1, b1, indices, *, A: int) -> torch.Tensor:
    """How far the bf16 variant's outputs (2B, A+1) (logits, then the
    value) may lie from its plain version's on the same inputs.

    Both round the row to bfloat16 alike, and every product of two
    bfloat16 values is exact in float32; they differ only in how their
    float32 sums round.  The plain version's first-layer sum of din
    products and the bias lies within (din + 1) roundings to nearest of
    2^-24 times the sum of its terms' magnitudes S of the exact value.
    The kernel sums on the tensor cores, whose float32 accumulation NVIDIA
    does not document.  The model taken is the one published measurements
    of earlier generations report (Fasi, Higham, Mikaitis and Pranesh,
    "Numerical behavior of NVIDIA tensor cores", PeerJ Computer Science 7,
    e330, 2021): the products are exact; a step adds a group of them to
    the float32 accumulator by aligning every addend to the largest one's
    exponent, dropping (truncating) the bits below float32's 24, summing
    exactly and truncating the normalized sum to float32; the bias is added
    after, rounded to nearest.  A step's truncations each lose less than
    2^-23 times its largest addend, so over din products in s = ceil(din /
    n) groups of n the kernel's pre-activation lies within (2 din + 4 s +
    1) 2^-24 S of the exact value, and within (3 din + 4 s + 2) 2^-24 S of
    the plain version's: 64 at A = 3 and 168 at A = 5 for n = 16, the
    instruction's depth, against the 38 and 102 of the slack below.  The
    slack stays twice the round-to-nearest bound, as for the CUDA-core
    order: truncations of addends of mixed signs partly cancel, a typical
    sum lies far inside it (tests/test_torch_rollout_actor_bf16.py holds
    this model's order, in groups of 4, 8 and 16, inside the band on the
    CPU), and ``check_bf16`` on the card is the arbiter.  Where that interval
    around the plain version's pre-activation holds a bfloat16 rounding
    midpoint (or 0, the ReLU's edge), the two may round the hidden unit
    to different bfloat16 values: such a unit is allowed the gap between
    them, times its second-layer weights.  Every output is also allowed
    1e-5 for the second layer's float32 sums in another order (the kernel
    sums them on the CUDA cores), as the float32 variant is; no other unit
    gets an allowance."""
    _, _, x, pre, _ = _seats_plain(table, w0, b0, indices, A)
    din = 2 * A * A
    slack = 2 * (din + 1) * 2.0 ** -24 * (x.abs() @ w0.float().abs()
                                          + b0.abs())
    lo, hi = (torch.relu(p).to(w0.dtype).float()
              for p in (pre - slack, pre + slack))
    return 1e-5 + (hi - lo) @ w1.float().abs()


def check_bf16(got: _Outputs, args, *, A: int, T: int) -> dict:
    """Holds the bf16 variant's outputs ``got`` on ``args`` (the arguments
    of ``fused_turn``, bf16 weights) to its plain version: logits and
    values within ``bf16_band``, the policy within half its row's band
    (softmax moves a probability by at most half the largest logit
    change), an action differing only where its two best scores lie
    within twice the row's band, and the transition of a lane whose
    actions agree equal.  Two controls must fall outside the band: the
    plain version that skips the bfloat16 rounding of the row, and the one
    that skips it for the hidden activation, each fed the same bf16
    weights; otherwise the band could not tell a kernel that skipped
    either.  Raises AssertionError; returns the largest output difference
    (``max_abs_err``), the near-ties and flipped lanes, the median row
    band, and each control's share of outputs outside the band."""
    table, w0, b0, w1, b1, indices, g_act, g_chance = args
    B = indices.shape[0]
    want = fused_turn_plain(*args, A=A, T=T)
    band = bf16_band(*args[:6], A=A)  # (2B, A+1)
    _, ml, mask, values = turn_logits_plain(*args[:6], A=A)
    row_band = torch.where(mask > 0, band[:, :A],
                           torch.zeros_like(mask)).amax(1)
    top2 = (ml + g_act).topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1] < 2 * row_band).reshape(2, B).any(0)
    new_g, pol_g, act_g, rew_g, val_g = got
    new_w, pol_w, act_w, rew_w, val_w = want
    flipped = (act_g != act_w).any(0)
    val_err = (val_g - val_w).abs().reshape(-1)
    pol_err = (pol_g - pol_w).abs().reshape(2 * B, A).amax(1)
    faults = {
        "lanes whose actions flip without a near-tie":
            int((flipped & ~near).sum()),
        "values outside the band": int((val_err > band[:, A]).sum()),
        "policy rows outside half the band":
            int((pol_err > 0.5 * row_band + 1e-6).sum()),
        "lanes whose actions agree and transitions differ":
            int(((new_g != new_w) | (rew_g != rew_w))[~flipped].sum())}
    if any(faults.values()):
        raise AssertionError(f"bf16 K1 parts from its plain version at "
                             f"A={A}: {faults}")
    plain = torch.cat([torch.where(mask > 0, ml, 0.0), values[:, None]], 1)
    controls = {}
    for skipped in ROUNDED:
        _, c_ml, _, c_val = turn_logits_plain(
            *args[:6], A=A, rounded=tuple(r for r in ROUNDED
                                          if r != skipped))
        ctrl = torch.cat([torch.where(mask > 0, c_ml, 0.0),
                          c_val[:, None]], 1)
        controls[f"unrounded {skipped}"] = float(
            ((ctrl - plain).abs() > band).float().mean())
    if not all(share > 0 for share in controls.values()):
        raise AssertionError(f"bf16 K1 check at A={A}: a control falls "
                             f"inside the band, which is too wide to tell "
                             f"it: {controls}")
    return {"max_abs_err": max(float(val_err.max()), float(pol_err.max())),
            "near_ties": int(near.sum()), "flipped": int(flipped.sum()),
            "row_band_median": float(row_band.median()),
            "controls": controls}


def fused_turn_plain(table, w0, b0, w1, b1, indices, g_act, g_chance, *,
                     A: int, T: int, store_obs: bool = False) -> _Outputs:
    """Plain version, op by op after the TPU kernel's body; with
    ``store_obs`` the lanes' observations (``stored_obs_plain``) last."""
    rows, ml, mask, values = turn_logits_plain(table, w0, b0, w1, b1,
                                               indices, A=A)
    out = turn_from_logits(table, rows, ml, mask, values, g_act, g_chance,
                           A=A, T=T)
    return out + (stored_obs_plain(rows, A),) if store_obs else out


def stored_obs_plain(rows: torch.Tensor, A: int) -> torch.Tensor:
    """Both seats' observations (2, B, 2, A, A) of the lanes' packed rows
    (B, D), seat-major: the row seat's view ``rows[:, 0:din]``, then the
    column seat's ``rows[:, din:2 din]``."""
    din = 2 * A * A
    obs = rows[:, :2 * din].reshape(-1, 2, 2, A, A)
    return obs.transpose(0, 1).contiguous()


def turn_from_logits(table, rows, ml, mask, values, g_act, g_chance, *,
                     A: int, T: int) -> _Outputs:
    """The turn after the forward: the masked softmax, the Gumbel-max
    actions and the transition, from the masked logits ``ml`` (2B, A),
    ``mask`` and ``values`` (2B,) of the lanes' packed ``rows``."""
    B = rows.shape[0]
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


def io_bytes(B: int, A: int, T: int, H: int, rows: int, cells: int,
             weight_bytes: int = 4, store_obs: bool = False) -> int:
    """Bytes that must cross device memory for ``B`` lanes' turns whose
    states take ``rows`` distinct packed rows and whose played joint
    cells are ``cells`` distinct (state, cell) pairs: each lane's index
    and noise read and its outputs written once (with ``store_obs`` its
    two observations, 2 din floats, among them), each distinct state's
    two observations and masks (2 din + 2 A floats), each distinct played
    cell's T log-chances, child and value (T + 2 floats), and the weights
    (``weight_bytes`` an element) and biases once."""
    din = 2 * A * A
    return (4 * (B + rows * (2 * din + 2 * A) + cells * (T + 2)
                 + H + A + 1  # biases
                 + 2 * B * A + B * T  # noise
                 + B + 2 * B * A + 2 * B + B + 2 * B  # outputs
                 + (2 * B * din if store_obs else 0))
            + weight_bytes * (din * H + H * (A + 1)))


def smem_bytes(A: int, H: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory the kernel's layout takes at (A, H) with weights of
    ``dtype``; builds the library on first use (the card's machine
    only)."""
    return _build.entry("fused_turn", "rnad_fused_turn_smem_bytes",
                        (ctypes.c_int32,) * 3, ctypes.c_size_t)(
        A, H, int(dtype == torch.bfloat16))


def fits(A: int, H: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the kernel takes hidden width H (2W) at A actions with
    weights of ``dtype``: its weights (float32 zero-padded to 64 units;
    bf16 to 32 units and W0's depth to a multiple of 16) and a tile's
    staged inputs fit in one block's shared memory."""
    return smem_bytes(A, H, dtype) <= SMEM_LIMIT_BYTES


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
        want_dtype = (torch.int32 if name == "indices" else
                      w0.dtype if name in ("w0", "w1") else torch.float32)
        if t.dtype != want_dtype:
            raise TypeError(f"fused_turn: {name} is {t.dtype}, want "
                            f"{want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_turn: {name} is not contiguous")
    if w0.dtype not in OPERAND_DTYPES:
        raise TypeError(f"fused_turn: weights are {w0.dtype}, want one of "
                        f"{OPERAND_DTYPES}")
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
               T: int, store_obs: bool = False) -> _Outputs:
    """One turn for all lanes.  ``table`` is the (S, D_pad) packed table,
    (w0, b0, w1, b1) the fused MLP of ``nets.mlp_fused_weights``, w0 and w1
    in float32 or bfloat16 (the bf16-operand variant).

    Returns (new_indices (B,) int32, policy (2, B, A), actions (2, B)
    int32, rewards (B,), values (2, B)), and with ``store_obs`` the lanes'
    observations (2, B, 2, A, A) float32 last."""
    _check_args(table, w0, b0, w1, b1, indices, g_act, g_chance, A, T)
    if table.device.type == "cpu":
        return fused_turn_plain(table, w0, b0, w1, b1, indices, g_act,
                                g_chance, A=A, T=T, store_obs=store_obs)
    if table.device.type != "cuda":
        raise ValueError(f"fused_turn runs on cuda or cpu, not {table.device}")
    H = w0.shape[1]
    bf16 = w0.dtype == torch.bfloat16
    if not fits(A, H, w0.dtype):
        raise ValueError(f"fused_turn keeps the weights in shared memory: "
                         f"{smem_bytes(A, H, w0.dtype)} bytes at A={A}, "
                         f"2W={H} with {w0.dtype} weights exceed "
                         f"{SMEM_LIMIT_BYTES}")
    if bf16 and (H % 2 or w0.data_ptr() % 4 or w1.data_ptr() % 4):
        raise ValueError("fused_turn's bfloat16 variant copies W0's rows "
                         "and W1 in 4-byte words: 2W must be even and the "
                         "weights 4-byte aligned")
    fn = _build.entry("fused_turn", "rnad_fused_turn", ARGTYPES)
    S, D = table.shape
    B = indices.shape[0]
    dev = table.device
    new_idx = torch.empty((B,), dtype=torch.int32, device=dev)
    policy = torch.empty((2, B, A), dtype=torch.float32, device=dev)
    actions = torch.empty((2, B), dtype=torch.int32, device=dev)
    rewards = torch.empty((B,), dtype=torch.float32, device=dev)
    values = torch.empty((2, B), dtype=torch.float32, device=dev)
    out = (new_idx, policy, actions, rewards, values)
    if store_obs:
        out += (torch.empty((2, B, 2, A, A), dtype=torch.float32,
                            device=dev),)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), S, D, indices.data_ptr(), w0.data_ptr(),
                 b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 g_act.data_ptr(), g_chance.data_ptr(), new_idx.data_ptr(),
                 policy.data_ptr(), actions.data_ptr(), rewards.data_ptr(),
                 values.data_ptr(), out[5].data_ptr() if store_obs else None,
                 B, A, T, H, int(bf16), stream)
    _build.check("fused_turn", "rnad_fused_turn", err)
    if bf16:
        fused_turn.launches_bf16 += 1
    else:
        fused_turn.launches += 1
    return out


# kernel launches (CUDA tensors only): the float32 and bf16 variants
fused_turn.launches = 0
fused_turn.launches_bf16 = 0
