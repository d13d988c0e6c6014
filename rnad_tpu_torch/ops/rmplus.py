"""Kernel K3: batched alternating RM+ for zero-sum matrix games.

Counterpart of ``rnad_tpu/ops/pallas_rmplus.py::rmplus``, whose body is
``rnad_tpu/env/solver_device.py::rmplus_core``; the CUDA source is
``csrc/rmplus.cu``.  Batch-minor: ``M (R, C, B)`` payoffs with illegal cells
zeroed, ``lr (R, B)`` and ``lc (C, B)`` masks -> ``x (R, B)``, ``y (C, B)``,
``v (B,)``, all float32.

``iters`` alternating (CFR+) updates: the column seat answers the row seat's
updated strategy, regrets are clipped at 0, and both strategies are averaged
with weight ``i + 1``.  The averages are then normalized and ``v`` is their
bilinear value.  R and C are at most 16 (the TPU kernel's own bound); larger
games raise.  ``rmplus`` launches the kernel for CUDA tensors and runs
``rmplus_plain`` only for CPU tensors.  Neither has a gradient: the EquiNet
reads the solve as a stop-gradient input feature.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

MAX_ACTIONS = 16
# rnad_rmplus(M, lr, lc, x, y, v, B, R, C, iters, stream)
ARGTYPES = ((ctypes.c_void_p,) * 6
            + (ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
               ctypes.c_int32, ctypes.c_void_p))

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _normalize(q: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    q = q * legal
    s = q.sum(0, keepdim=True)
    uniform = legal / torch.clamp(legal.sum(0, keepdim=True), min=1.0)
    return torch.where(s > 0, q / torch.clamp(s, min=1e-30), uniform)


@torch.no_grad()
def rmplus_plain(M: torch.Tensor, lr: torch.Tensor, lc: torch.Tensor,
                 iters: int) -> _Outputs:
    """Plain version, op by op after ``rmplus_core``."""
    R, C, B = M.shape
    qr = torch.zeros((R, B), dtype=M.dtype, device=M.device)
    qc = torch.zeros((C, B), dtype=M.dtype, device=M.device)
    xsum = torch.zeros_like(qr)
    ysum = torch.zeros_like(qc)
    for i in range(iters):
        y = _normalize(qc, lc)
        u_r = (M * y[None, :, :]).sum(1)  # (R, B) row action utilities
        v_r = (_normalize(qr, lr) * u_r).sum(0, keepdim=True)
        qr = torch.clamp(qr + (u_r - v_r) * lr, min=0.0)
        x = _normalize(qr, lr)
        u_c = -(M * x[:, None, :]).sum(0)  # (C, B) col action utilities
        v_c = (y * u_c).sum(0, keepdim=True)
        qc = torch.clamp(qc + (u_c - v_c) * lc, min=0.0)
        y = _normalize(qc, lc)
        w = float(i + 1)  # linear averaging
        xsum = xsum + w * x
        ysum = ysum + w * y
    x = _normalize(xsum, lr)
    y = _normalize(ysum, lc)
    v = (x[:, None, :] * M * y[None, :, :]).sum((0, 1))
    return x, y, v


def operations(R: int, C: int, iters: int) -> int:
    """Arithmetic operations one game's solve needs when its masks hold
    only 0 and 1, as every caller's do (a product, a sum, a division, a max
    or a select counts one).  The products by the mask are then exact
    no-ops, which the kernel skips, so they are not counted.

    Per iteration: both seats' utilities (2RC each, and C negations) and
    values (2R, 2C), the regret updates (3R, 3C: difference, sum, clip),
    two normalizations (3R + 1, 3C + 1: sum, division and select per
    action, one max), the weight (1) and the two running averages (2R,
    2C).  After the loop: two normalizations and the value (3RC)."""
    per_iter = 4 * R * C + 10 * R + 11 * C + 3
    return iters * per_iter + 3 * (R + C) + 2 + 3 * R * C


def io_bytes(R: int, C: int, B: int) -> int:
    """Bytes that must cross device memory: M and both masks read once,
    x, y and v written once."""
    return 4 * B * (R * C + R + C + R + C + 1)


def _check_args(M, lr, lc, iters) -> None:
    if M.dim() != 3:
        raise ValueError(f"rmplus wants M (R, C, B), got {tuple(M.shape)}")
    R, C, B = M.shape
    if not 1 <= R <= MAX_ACTIONS or not 1 <= C <= MAX_ACTIONS:
        raise ValueError(f"rmplus supports 1 <= R, C <= {MAX_ACTIONS} "
                         f"(MAX_ACTIONS), got R={R}, C={C}")
    for name, t, shape in (("M", M, (R, C, B)), ("lr", lr, (R, B)),
                           ("lc", lc, (C, B))):
        if tuple(t.shape) != shape:
            raise ValueError(f"rmplus: {name} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"rmplus: {name} is {t.dtype}, want float32")
        if t.device != M.device:
            raise ValueError(f"rmplus: {name} is on {t.device}, M on "
                             f"{M.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmplus: {name} is not contiguous")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"rmplus: iters must be a count >= 0, got {iters}")


def rmplus(M: torch.Tensor, lr: torch.Tensor, lc: torch.Tensor,
           iters: int) -> _Outputs:
    """Batch-minor RM+: M (R, C, B) with illegal cells zeroed, lr (R, B),
    lc (C, B) -> (x (R, B), y (C, B), v (B,)).

    Every caller's masks hold only 0.0 and 1.0 (the ``amax`` of a 0/1
    legality channel).  For such a game the kernel skips the plain
    version's products by the mask, which are then exact no-ops (a regret
    on an illegal action stays +0); a game with any other mask value keeps
    them, so every mask gets the plain version's function
    (csrc/rmplus.cu, step 1).  The kernel also takes one reciprocal per
    normalization and contracts products into FMAs, so its rounding
    differs from the plain version's; ``solver_device.agreement`` is the
    criterion the two are held to."""
    _check_args(M, lr, lc, iters)
    if M.device.type == "cpu":
        return rmplus_plain(M, lr, lc, iters)
    if M.device.type != "cuda":
        raise ValueError(f"rmplus runs on cuda or cpu, not {M.device}")
    fn = _build.entry("rmplus", "rnad_rmplus", ARGTYPES)
    R, C, B = M.shape
    dev = M.device
    x = torch.empty((R, B), dtype=torch.float32, device=dev)
    y = torch.empty((C, B), dtype=torch.float32, device=dev)
    v = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return x, y, v
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(M.data_ptr(), lr.data_ptr(), lc.data_ptr(), x.data_ptr(),
                 y.data_ptr(), v.data_ptr(), B, R, C, int(iters), stream)
    _build.check("rmplus", "rnad_rmplus", err)
    rmplus.launches += 1
    return x, y, v


rmplus.launches = 0  # kernel launches (CUDA tensors only)
