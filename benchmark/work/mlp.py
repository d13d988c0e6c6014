"""The two-head MLP's train step, counted from shapes: frozen from
``rnad_tpu_torch/roofline.py`` (``MLPStep``, ``step_phases``) for the fused
on-policy step that stores the rollout's observations.

Products are the matmuls only, an FMA counting two: the rollout's
per-seat forwards (K1's own operations), the learner's forward, the frozen
passes in "heads" mode (the target's value tower, the regularization
pair's policy towers, and with ``detailed_metrics`` the target's policy
tower) and the backward (every layer's weight gradient and every layer's
input gradient but the first's).  Bytes: K1's, the learner's observation
and mask reads, each pass's inputs and outputs, 24 passes of v-trace over
(T, B, A), the gradients, and Adam's and the EMA's reads and writes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..reference.nets import in_channels
from . import kernels
from .peaks import Work

Matmul = Tuple[int, int, int]


def _elt(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def forward_matmuls(n: int, A: int, width: int, depth: int = 1,
                    heads: Optional[Tuple[int, ...]] = None,
                    cin: int = 2) -> List[Matmul]:
    din = cin * A * A
    ms: List[Matmul] = []
    for out in (heads if heads is not None else (A, 1)):
        ms.append((n, din, width))
        ms += [(n, width, width)] * (depth - 1)
        ms.append((n, width, out))
    return ms


def backward_matmuls(n: int, A: int, width: int, depth: int = 1,
                     cin: int = 2) -> List[Matmul]:
    ms: List[Matmul] = []
    for i, (M, K, N) in enumerate(forward_matmuls(n, A, width, depth,
                                                  cin=cin)):
        ms.append((K, M, N))
        if i % (depth + 1):
            ms.append((M, N, K))
    return ms


def flops(ms: List[Matmul]) -> float:
    return float(sum(2 * M * K * N for M, K, N in ms))


def params(A: int, width: int, depth: int = 1, cin: int = 2) -> int:
    return sum(K * N + N for _, K, N in forward_matmuls(1, A, width, depth,
                                                        cin=cin))


def phases(config: dict, lanes: int, levels: int, rows: float,
           cells: float) -> List[Tuple[str, Work]]:
    """(name, work) of the step's phases: rollout, learner + frozen
    passes, backward, clip + Adam + EMA."""
    net, cfg = config["net"], config["rnad"]
    A = config["tree"]["max_actions"]
    W, depth = net["width"], net.get("depth", 1)
    dtype = net["compute_dtype"]
    frozen_dtype = (dtype if cfg["frozen_net_dtype"] == "float32"
                    else cfg["frozen_net_dtype"])
    n = 2 * levels * lanes
    cin = in_channels(config)
    din = cin * A * A
    roll = kernels.k1_step(config, lanes, levels, rows, cells)
    frozen = (forward_matmuls(n, A, W, depth, (1,), cin)
              + forward_matmuls(2 * n, A, W, depth, (A,), cin))
    passes = 4
    if cfg.get("detailed_metrics", True):
        frozen += forward_matmuls(n, A, W, depth, (A,), cin)
        passes += 1
    learner = (Work({dtype: flops(forward_matmuls(n, A, W, depth,
                                                  cin=cin))})
               + Work({frozen_dtype: flops(frozen)},
                      4.0 * n * (din + A)
                      + passes * n * (2 * din + A + 1) * _elt(dtype)
                      + 24.0 * n * A * 4))
    backward = Work({dtype: flops(backward_matmuls(n, A, W, depth, cin))},
                    2.0 * n * (2 * din + A + 1) * _elt(dtype)
                    + 4.0 * params(A, W, depth, cin))
    update = Work({}, 4.0 * 9 * params(A, W, depth, cin))
    return [("rollout", roll),
            ("learner + frozen passes, v-trace, loss", learner),
            ("backward", backward), ("clip + Adam + EMA", update)]


def step(config: dict, lanes: int, levels: int, rows: Optional[float] = None,
         cells: Optional[float] = None) -> Work:
    """The whole step; without the distinct counts every lane's turn is
    charged a row and a cell of its own."""
    most = float(lanes * levels)
    out = Work({})
    for _, work in phases(config, lanes, levels,
                          most if rows is None else rows,
                          most if cells is None else cells):
        out = out + work
    return out
