"""The native (C++) tree generator and batched simplex: build, load and
call.

Counterpart of ``rnad_tpu/native.py``.  ``csrc/treegen.cpp`` and
``csrc/solver.cpp`` are the port's own copies of ``rnad_tpu``'s sources: a
level-synchronous generator in C++ with OpenMP and the batched simplex
that solves each level, which ``env/solver.py`` also calls directly for the
numpy generator's levels.  They are host code, not CUDA kernels.  The first call compiles both with ``g++`` into one shared
library under ``rnad_tpu_torch/_build/`` (git-ignored), named by a hash of
the sources, and binds it with ctypes.

The compiler flags are ``rnad_tpu``'s: ``-ffp-contract=off`` keeps every
``a * b + c`` two roundings, on which the content hash of a generated tree
depends.  A failed build or load, or a nonzero status, raises; there is no
fallback (the numpy generator in ``env/tree.py`` makes a different tree
for the same seed, and the numpy simplex rounds the game values otherwise
in their last bits, which would change the content hash without a word).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("solver.cpp", "treegen.cpp")
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared",
         "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_ERRORS = {
    -2: "tree exceeded max_nodes={max_nodes} (runaway shaping rule?)",
    -3: "a game matrix failed to solve (see stderr for the matrix)",
    -4: "max_transitions must be in [1, 64]",
    -5: "max_actions and len(terminal_values) must be >= 1",
}


def library_path() -> Path:
    """Where the library of the current sources lives."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libtreegen-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the sources unless their library exists; returns its path.
    The compiler writes a temporary file named by this process, which is
    then renamed into place, so concurrent builders never load a partial
    library.  Raises ``RuntimeError`` if the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native treegen build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native treegen build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library with its ctypes signatures, built first if
    needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.solve_zero_sum_batch.restype = ctypes.c_int
        lib.solve_zero_sum_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # payoff
            ctypes.POINTER(ctypes.c_int),  # rows
            ctypes.POINTER(ctypes.c_int),  # cols
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, rows, cols
            ctypes.POINTER(ctypes.c_double),  # row_strat
            ctypes.POINTER(ctypes.c_double),  # col_strat
            ctypes.POINTER(ctypes.c_double),  # values
        ]
        lib.treegen_generate.restype = ctypes.c_int64
        lib.treegen_generate.argtypes = [
            ctypes.c_uint64,  # seed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # A, T, depth_bound
            ctypes.c_int, ctypes.c_int,  # root_row, root_col
            ctypes.c_double,  # threshold
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,  # terminal values
            ctypes.c_int, ctypes.c_int, ctypes.c_double,  # row rule
            ctypes.c_int, ctypes.c_int, ctypes.c_double,  # col rule
            ctypes.c_int, ctypes.c_int, ctypes.c_double,  # depth rule
            ctypes.c_int64,  # max_nodes
        ]
        lib.treegen_fetch.restype = ctypes.c_int
        lib.treegen_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.treegen_free.restype = None
        lib.treegen_free.argtypes = []
        _lib = lib
        return lib


def solve_zero_sum_batch_native(payoff: np.ndarray, rows: np.ndarray,
                                cols: np.ndarray):
    """The C++ batched simplex on (batch, max_rows, max_cols) payoffs with
    active sizes ``rows``, ``cols``: (row_strat, col_strat, values) as
    float64 arrays.  Raises ``RuntimeError`` on a nonzero status."""
    lib = library()
    payoff = np.ascontiguousarray(payoff, dtype=np.float64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    batch, max_r, max_c = payoff.shape
    row_strat = np.zeros((batch, max_r), dtype=np.float64)
    col_strat = np.zeros((batch, max_c), dtype=np.float64)
    values = np.zeros((batch,), dtype=np.float64)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    status = lib.solve_zero_sum_batch(
        dptr(payoff), iptr(rows), iptr(cols), batch, max_r, max_c,
        dptr(row_strat), dptr(col_strat), dptr(values))
    if status != 0:
        raise RuntimeError(f"native solver returned status {status}")
    return row_strat, col_strat, values


def generate_tree_arrays(seed: int, max_actions: int, max_transitions: int,
                         depth_bound: int, root_row: int, root_col: int,
                         threshold: float, terminal_values, rules,
                         max_nodes: int = 1 << 24) -> Dict[str, np.ndarray]:
    """Runs the C++ generator; returns the tree's numpy arrays.  ``rules``
    is ((delta, stochastic_delta, prob) x 3) for the row, column and depth
    shaping rules."""
    lib = library()
    tv = np.ascontiguousarray(terminal_values, dtype=np.float64)
    (rr, rc, rd) = rules
    with _lock:  # the library keeps one generated tree at a time
        size = lib.treegen_generate(
            ctypes.c_uint64(seed & (2**64 - 1)), max_actions, max_transitions,
            depth_bound, root_row, root_col, float(threshold),
            tv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), tv.size,
            int(rr[0]), int(rr[1]), float(rr[2]),
            int(rc[0]), int(rc[1]), float(rc[2]),
            int(rd[0]), int(rd[1]), float(rd[2]),
            max_nodes)
        if size < 0:
            reason = _ERRORS.get(int(size), f"code {size}")
            raise RuntimeError("native treegen failed: "
                               + reason.format(max_nodes=max_nodes))
        A, T, S = max_actions, max_transitions, int(size)
        out = dict(index=np.zeros((S, T, A, A), np.int32),
                   value=np.zeros((S, T, A, A), np.float32),
                   chance=np.zeros((S, T, A, A), np.float32),
                   expected_value=np.zeros((S, 1, A, A), np.float32),
                   legal=np.zeros((S, 1, A, A), np.float32),
                   solution=np.zeros((S, 2 * A), np.float32),
                   root_value=np.zeros((S, 1), np.float32),
                   depth=np.zeros((S,), np.int32))
        i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        status = lib.treegen_fetch(
            i32(out["index"]), f32(out["value"]), f32(out["chance"]),
            f32(out["expected_value"]), f32(out["legal"]),
            f32(out["solution"]), f32(out["root_value"]), i32(out["depth"]))
        lib.treegen_free()
    if status != 0:
        raise RuntimeError("native treegen fetch failed")
    return out
