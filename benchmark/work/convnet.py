"""The ConvNet's train step, counted from shapes: its products, an FMA
counting two, at their compute type; only the multiply-adds a result
needs.

A CrossConv over n observations (A x A cells) from C_in to C_out channels
is a row and a column convolution; each output cell takes its whole row
(column), A cells of C_in channels, against its C_out taps: 2 n A^2 A
C_in C_out products a convolution.  The zero padding's taps, which a
(2A - 1)-wide convolution would also multiply, are not counted.  One
forward over n observations with c0 input channels (2 raw, or the lift's
C + 1) is the ``pre`` CrossConv (c0 to C), ``depth`` blocks of two
CrossConvs (C to C), and the policy (A) and value (1) heads on the
flattened C A^2 features.  BatchNorm, ReLU and the residual adds are not
products.  The step is the rollout's forwards of both seats (2B
observations a turn), the learner's forward, the three frozen forwards
(the EMA target and the regularization pair, in ``frozen_net_dtype``
where it is bfloat16) over the 2 levels B half-steps, and the backward:
every product's weight gradient and the input gradient of every layer
but the first, whose input is the observation.
"""

from __future__ import annotations

from typing import List

from ..reference.nets import in_channels
from .peaks import Work


def cross_conv_flops(n: int, A: int, cin: int, cout: int) -> float:
    """One CrossConv's row and column products over n observations."""
    return 2 * 2.0 * n * A * A * A * cin * cout


def heads_flops(n: int, A: int, C: int) -> float:
    return 2.0 * n * C * A * A * (A + 1)


def forward_flops(n: int, A: int, C: int, depth: int, c0: int) -> float:
    return (cross_conv_flops(n, A, c0, C)
            + 2 * depth * cross_conv_flops(n, A, C, C) + heads_flops(n, A, C))


def backward_flops(n: int, A: int, C: int, depth: int, c0: int) -> float:
    """Weight gradients of every product, input gradients of every layer
    after the ``pre`` CrossConv."""
    inputs = 2 * depth * cross_conv_flops(n, A, C, C) + heads_flops(n, A, C)
    return forward_flops(n, A, C, depth, c0) + inputs


def phases(config: dict, lanes: int, levels: int) -> List:
    net, cfg = config["net"], config["rnad"]
    A, C, depth = config["tree"]["max_actions"], net["channels"], net["depth"]
    c0 = in_channels(config)
    dtype = net["compute_dtype"]
    frozen_dtype = (dtype if cfg["frozen_net_dtype"] == "float32"
                    else cfg["frozen_net_dtype"])
    n = 2 * levels * lanes
    return [("rollout", Work({dtype: levels * forward_flops(
                2 * lanes, A, C, depth, c0)})),
            ("learner + frozen passes",
             Work({dtype: forward_flops(n, A, C, depth, c0)})
             + Work({frozen_dtype: 3 * forward_flops(n, A, C, depth, c0)})),
            ("backward", Work({dtype: backward_flops(n, A, C, depth, c0)}))]


def step(config: dict, lanes: int, levels: int, rows=None,
         cells=None) -> Work:
    del rows, cells
    out = Work({})
    for _, work in phases(config, lanes, levels):
        out = out + work
    return out
