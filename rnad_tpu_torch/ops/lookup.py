"""Kernel K2: the packed-row lookup ``out[b, :] = table[idx[b], :]``.

Counterpart of ``rnad_tpu/ops/pallas_lookup.py::onehot_lookup``; the CUDA
source is ``csrc/lookup.cu``.  ``lookup`` launches the kernel for CUDA
tensors and runs ``lookup_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p)


def lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: one indexing gather."""
    return table[idx.long()]


def _check_args(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"lookup wants a (S, D) table and (N,) ids, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"lookup wants a float32 table and int32 ids, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.shape[1] % 4:
        raise ValueError(f"lookup reads 16-byte chunks: D={table.shape[1]} "
                         "must be a multiple of 4")
    if table.device != idx.device:
        raise ValueError("table and ids must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lookup wants contiguous tensors")


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, D) float32 table, (N,) int32 ids -> (N, D) rows, bit-exact."""
    _check_args(table, idx)
    if table.device.type == "cpu":
        return lookup_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"lookup runs on cuda or cpu, not {table.device}")
    fn = _build.entry("lookup", "rnad_lookup", _ARGTYPES)
    S, D = table.shape
    N = idx.shape[0]
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if N == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, S, D,
                 stream)
    _build.check("lookup", "rnad_lookup", err)
    lookup.launches += 1
    return out


lookup.launches = 0  # kernel launches (CUDA tensors only)
