"""The plain two-head MLP (``rnad_tpu/models/nets.py``'s MLP): a policy
head and a value head, each fc0, ``depth`` - 1 hidden layers and fc1 with
ReLU between, on the flattened observation."""

from __future__ import annotations

from typing import Tuple

import torch

from ..nets import Params, Precision


def head(params: Params, x: torch.Tensor, name: str, depth: int,
         prec: Precision) -> torch.Tensor:
    """One head: fc0, depth - 1 hidden layers, fc1, ReLU between."""
    h = x.to(prec.dtype)
    layers = [f"{name}_fc0"] + [f"{name}_hidden{i}" for i in range(1, depth)]
    for layer in layers:
        h = torch.relu(prec.dense(h, params[f"{layer}.weight"],
                                  params[f"{layer}.bias"]))
    return prec.dense(h, params[f"{name}_fc1.weight"],
                      params[f"{name}_fc1.bias"]).float()


def forward(params: Params, obs: torch.Tensor, net: dict, prec: Precision,
            feats=None, state=None, train: bool = False, mask=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, A, A) observations -> (logits (N, A), values (N,)); the MLP
    keeps no state and has no train mode."""
    del feats, state, train, mask
    x = obs.reshape(obs.shape[0], -1)
    depth = net.get("depth", 1)
    return (head(params, x, "policy", depth, prec),
            head(params, x, "value", depth, prec)[:, 0])


def features(net: dict, obs: torch.Tensor, solver=None) -> None:
    """The MLP shares nothing between its passes."""
    return None


def param_shapes(net: dict, A: int, in_channels: int = 2):
    """The leaves at A actions and ``in_channels`` input channels in the
    program's state_dict order: (name, shape, bound), each starting
    U(-bound, bound), torch's Linear default of its layer."""
    din, W, depth = in_channels * A * A, net["width"], net.get("depth", 1)
    out = []
    for name, fan, width in (("policy_fc0", din, W), ("policy_fc1", W, A),
                             ("value_fc0", din, W), ("value_fc1", W, 1)):
        out += [(f"{name}.weight", (width, fan), fan ** -0.5),
                (f"{name}.bias", (width,), fan ** -0.5)]
    for name in ("policy", "value"):
        for i in range(1, depth):
            out += [(f"{name}_hidden{i}.weight", (W, W), W ** -0.5),
                    (f"{name}_hidden{i}.bias", (W,), W ** -0.5)]
    return out
