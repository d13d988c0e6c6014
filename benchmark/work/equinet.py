"""The EquiNet's train step, counted from shapes: its matmul products,
an FMA counting two, at the net's compute type.

One forward over n observations (A x A cells, C channels, c0 input
channels: 2 raw or the lift's C + 1, and 6 more with solver features)
takes, in each
exchangeable layer of C_in input channels, six block products against
its (C_in, C) kernel blocks: the cells' (n A^2 rows), the row and column
means' and maxes' (n A rows each) and the global mean's (n rows); then the
policy head on each row's pooled features (n A rows of C + c0) and the
value head on the global ones (n rows).  The step is the rollout's
per-seat forwards (2B observations a turn), the learner's four passes
(the learner, the EMA target and the regularization pair) over the 2
levels B half-steps, and the backward: every product's weight gradient,
and the input gradient of every layer whose input needs one (not the
first layer's, whose input is the observation and the solve; the heads'
only for the tower's C channels).  The RM+ solve (K3) and its two
utility contractions are not products of the net; K3 has its own bound
(``kernels.k3_step_bound_s``).
"""

from __future__ import annotations

from typing import List

from ..reference.nets import in_channels
from .peaks import Work


def layer_flops(n: int, A: int, cin: int, C: int) -> float:
    """One exchangeable layer's six block products over n observations."""
    rows = n * (A * A + 4 * A + 1)
    return 2.0 * rows * cin * C


def forward_flops(n: int, A: int, C: int, depth: int, c0: int) -> float:
    cins = [c0] + [C] * (depth - 1)
    tower = sum(layer_flops(n, A, cin, C) for cin in cins)
    heads = 2.0 * n * A * (C + c0) + 2.0 * n * (C + c0)
    return tower + heads


def backward_flops(n: int, A: int, C: int, depth: int, c0: int) -> float:
    """Weight gradients of every product, input gradients of the layers
    after the first and of the heads' tower channels."""
    weights = forward_flops(n, A, C, depth, c0)
    inputs = (sum(layer_flops(n, A, C, C) for _ in range(depth - 1))
              + 2.0 * n * A * C + 2.0 * n * C)
    return weights + inputs


def shape(config: dict):
    net = config["net"]
    c0 = in_channels(config) + (6 if net.get("solver_iters", 0) else 0)
    return (config["tree"]["max_actions"], net["channels"], net["depth"],
            c0)


def phases(config: dict, lanes: int, levels: int) -> List:
    A, C, depth, c0 = shape(config)
    dtype = config["net"]["compute_dtype"]
    n = 2 * levels * lanes
    return [("rollout", Work({dtype: levels * forward_flops(
                2 * lanes, A, C, depth, c0)})),
            ("learner + frozen passes", Work({dtype: 4 * forward_flops(
                n, A, C, depth, c0)})),
            ("backward", Work({dtype: backward_flops(n, A, C, depth, c0)}))]


def step(config: dict, lanes: int, levels: int, rows=None,
         cells=None) -> Work:
    del rows, cells
    out = Work({})
    for _, work in phases(config, lanes, levels):
        out = out + work
    return out
