"""The game trees the cells train on, made by the benchmark itself.

A configuration's ``tree`` group names a generator and its parameters.
Both generators are frozen copies of the program's, so that a change to the
program cannot change the inputs it is measured on:

* ``"numpy"``: ``rnad_tpu_torch/env/tree.py::generate_tree`` (one numpy
  ``Generator`` drawn in a fixed order, each level solved exactly), used by
  the reference experiment's 306-node demo tree;
* ``"native"``: the C++ level-synchronous generator
  (``native/treegen.cpp``), used by the 785,768-node trees.

Both solve every level with the C++ batched simplex (``native/solver.cpp``),
compiled with g++ on first use into ``benchmark/.cache/native/`` under a
hash of the sources.  A generated tree is kept in ``benchmark/.cache/trees/``
under a hash of its parameters, so only the first run of a checkout pays
for it; ``make_tree`` says whether it generated or loaded.

The arrays follow the program's ``GameTree`` fields: ``index``, ``value``,
``chance`` (S, T, A, A), ``expected_value``, ``legal`` (S, 1, A, A),
``solution`` (S, 2A), ``root_value`` (S, 1) and ``depth`` (S,).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
SOURCES = (HERE / "native" / "solver.cpp", HERE / "native" / "treegen.cpp")
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared",
         "-fPIC")
FIELDS = ("index", "value", "chance", "expected_value", "legal", "solution",
          "root_value", "depth")


def _library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES))
    return CACHE / "native" / f"libtreegen-{digest.hexdigest()[:16]}.so"


def _library() -> ctypes.CDLL:
    """The frozen generator and simplex, built first if needed."""
    out = _library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"tree generator build failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    lib.solve_zero_sum_batch.restype = ctypes.c_int
    lib.solve_zero_sum_batch.argtypes = [dp, ip, ip, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, dp, dp,
                                         dp]
    rule = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.treegen_generate.restype = ctypes.c_int64
    lib.treegen_generate.argtypes = (
        [ctypes.c_uint64] + [ctypes.c_int] * 5 + [ctypes.c_double, dp,
                                                  ctypes.c_int]
        + rule * 3 + [ctypes.c_int64])
    i32p, f32p = (ctypes.POINTER(ctypes.c_int32),
                  ctypes.POINTER(ctypes.c_float))
    lib.treegen_fetch.restype = ctypes.c_int
    lib.treegen_fetch.argtypes = [i32p] + [f32p] * 6 + [i32p]
    lib.treegen_free.restype = None
    lib.treegen_free.argtypes = []
    return lib


def _solve(lib, payoff: np.ndarray, rows: np.ndarray, cols: np.ndarray):
    """The C++ simplex on (n, A, A) games of active sizes rows x cols:
    (row strategies, column strategies, values), float64."""
    payoff = np.ascontiguousarray(payoff, dtype=np.float64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n, max_r, max_c = payoff.shape
    x = np.zeros((n, max_r))
    y = np.zeros((n, max_c))
    v = np.zeros((n,))
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    if lib.solve_zero_sum_batch(dptr(payoff), iptr(rows), iptr(cols), n,
                                max_r, max_c, dptr(x), dptr(y), dptr(v)):
        raise RuntimeError("tree solver failed")
    return x, y, v


def _shape(rule, value: np.ndarray, u: np.ndarray) -> np.ndarray:
    delta, stochastic_delta, prob = rule
    out = value + delta
    if prob > 0.0 and stochastic_delta != 0:
        out = out + (u < prob) * stochastic_delta
    return out


def _rules(cfg: dict):
    return [tuple(cfg[k]) for k in ("row_actions_rule", "col_actions_rule",
                                    "depth_bound_rule")]


def generate_numpy(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The program's numpy generator: levels top-down from one
    ``numpy.random.Generator`` (Dirichlet(1/T) chance profiles, the three
    shaping-rule uniforms, the terminal draws), solved bottom-up."""
    A, T = cfg["max_actions"], cfg["max_transitions"]
    row_rule, col_rule, depth_rule = _rules(cfg)
    rng = np.random.default_rng(seed)
    terminal_values = np.asarray(cfg["terminal_values"], dtype=np.float64)
    levels = []
    f_rows = np.array([cfg.get("row_actions") or A], dtype=np.int64)
    f_cols = np.array([cfg.get("col_actions") or A], dtype=np.int64)
    f_depth = np.array([cfg["depth_bound"]], dtype=np.int64)
    f_ids = np.array([1], dtype=np.int64)
    next_id = 2
    while f_ids.size:
        n = f_ids.size
        if T == 1:
            ch = np.ones((n, A, A, 1))
        else:
            raw = rng.dirichlet((1.0 / T,) * T, size=(n, A, A))
            ch = np.where(raw < cfg["transition_threshold"], 0.0, raw)
            dead = ch.sum(axis=-1) == 0.0
            if dead.any():
                mx = np.zeros_like(ch)
                np.put_along_axis(mx, raw.argmax(axis=-1, keepdims=True),
                                  1.0, axis=-1)
                ch = np.where(dead[..., None], mx, ch)
            ch = ch / ch.sum(axis=-1, keepdims=True)
        r = np.arange(A)
        legal = ((r[None, :, None] < f_rows[:, None, None])
                 & (r[None, None, :] < f_cols[:, None, None]))
        ch = ch * legal[..., None]
        ci, cr, cc, ct = np.nonzero(ch > 0.0)
        k = ci.size
        c_rows = np.clip(_shape(row_rule, f_rows[ci], rng.random(k)), 1, A)
        c_cols = np.clip(_shape(col_rule, f_cols[ci], rng.random(k)), 1, A)
        c_depth = np.maximum(0, _shape(depth_rule, f_depth[ci],
                                       rng.random(k)))
        internal = c_depth > 0
        c_ids = np.zeros(k, dtype=np.int64)
        c_ids[internal] = next_id + np.arange(int(internal.sum()))
        next_id += int(internal.sum())
        term = rng.choice(terminal_values, size=k)
        index = np.zeros((n, T, A, A), dtype=np.int64)
        index[ci, ct, cr, cc] = c_ids
        term_value = np.zeros((n, T, A, A))
        out = ~internal
        term_value[ci[out], ct[out], cr[out], cc[out]] = term[out]
        levels.append((f_ids, f_rows, f_cols, np.moveaxis(ch, 3, 1),
                       legal[:, None].astype(np.float64), index, term_value))
        f_rows, f_cols = c_rows[internal], c_cols[internal]
        f_depth, f_ids = c_depth[internal], c_ids[internal]

    S = next_id
    lib = _library()
    node_value = np.zeros(S)
    node_depth = np.zeros(S, dtype=np.int64)
    arrays = {"index": np.zeros((S, T, A, A), np.int64),
              "value": np.zeros((S, T, A, A)),
              "chance": np.zeros((S, T, A, A)),
              "expected_value": np.zeros((S, 1, A, A)),
              "legal": np.zeros((S, 1, A, A)),
              "solution": np.zeros((S, 2 * A))}
    for ids, rows, cols, chance, legal, index, term_value in reversed(levels):
        inner = index > 0
        value = np.where(inner, node_value[index], term_value)
        ev = (chance * value).sum(axis=1)
        x, y, v = _solve(lib, ev, rows, cols)
        node_value[ids] = v
        arrays["solution"][ids] = np.concatenate([x, y], axis=1)
        child_depth = np.where(inner, node_depth[index], 0) * (chance > 0)
        node_depth[ids] = 1 + child_depth.max(axis=(1, 2, 3))
        arrays["index"][ids] = index
        arrays["value"][ids] = value
        arrays["chance"][ids] = chance
        arrays["expected_value"][ids, 0] = ev
        arrays["legal"][ids] = legal
    arrays["chance"][0, 0, 0, 0] = 1.0  # the absorbing state self-loops
    arrays["legal"][0, 0, 0, 0] = 1.0
    out = {k: a.astype(np.float32) for k, a in arrays.items()}
    out["index"] = arrays["index"].astype(np.int32)
    out["root_value"] = node_value[:, None].astype(np.float32)
    out["depth"] = node_depth.astype(np.int32)
    return out


def generate_native(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """The program's C++ generator, seeded as it seeds it."""
    lib = _library()
    A, T = cfg["max_actions"], cfg["max_transitions"]
    tv = np.ascontiguousarray(cfg["terminal_values"], dtype=np.float64)
    rules = [x for rule in _rules(cfg) for x in
             (int(rule[0]), int(rule[1]), float(rule[2]))]
    size = lib.treegen_generate(
        ctypes.c_uint64(seed & (2**64 - 1)), A, T, cfg["depth_bound"],
        cfg.get("row_actions") or A, cfg.get("col_actions") or A,
        float(cfg["transition_threshold"]),
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), tv.size,
        *rules, 1 << 24)
    if size < 0:
        raise RuntimeError(f"tree generator failed with code {size}")
    S = int(size)
    out = {"index": np.zeros((S, T, A, A), np.int32),
           "value": np.zeros((S, T, A, A), np.float32),
           "chance": np.zeros((S, T, A, A), np.float32),
           "expected_value": np.zeros((S, 1, A, A), np.float32),
           "legal": np.zeros((S, 1, A, A), np.float32),
           "solution": np.zeros((S, 2 * A), np.float32),
           "root_value": np.zeros((S, 1), np.float32),
           "depth": np.zeros((S,), np.int32)}
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(
        ctypes.c_int32 if a.dtype == np.int32 else ctypes.c_float))
    status = lib.treegen_fetch(*(ptr(out[k]) for k in FIELDS))
    lib.treegen_free()
    if status != 0:
        raise RuntimeError("tree generator fetch failed")
    return out


GENERATORS = {"numpy": generate_numpy, "native": generate_native}


def make_tree(cfg: dict) -> Tuple[Dict[str, np.ndarray], bool, float]:
    """The tree of a configuration's ``tree`` group (its ``generator``,
    ``seed`` and the generator's parameters): (arrays, generated, seconds),
    where ``generated`` says this call made the tree rather than loading it
    from the cache."""
    start = time.perf_counter()
    cache = CACHE / "trees"
    key = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()
                         + b"".join(s.read_bytes() for s in SOURCES))
    path = cache / f"{cfg['generator']}-{key.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as f:
            arrays = {k: f[k] for k in FIELDS}
        return arrays, False, time.perf_counter() - start
    arrays = GENERATORS[cfg["generator"]](cfg, int(cfg["seed"]))
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays, True, time.perf_counter() - start
