"""The two-head policy/value MLP and its fused-weight forms.

Counterpart of ``rnad_tpu/models/nets.py`` for the depth-1 MLP (the
reference architecture): the flattened (2, A, A) observation feeds two
separate one-hidden-layer heads, ``policy_fc0 -> relu -> policy_fc1``
(A logits) and ``value_fc0 -> relu -> value_fc1`` (one value).

Weights cross between the packages through the carrier below: a flax Dense
kernel is (in, out) and a torch Linear weight is (out, in), so the carrier
transposes.  Initialization is torch's own Linear default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, which is the
distribution ``rnad_tpu``'s ``torch_linear_kernel_init`` reproduces; draws
come from an explicit generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import NetConfig

_LAYERS = ("policy_fc0", "policy_fc1", "value_fc0", "value_fc1")


class MLP(nn.Module):
    """Two-headed depth-1 MLP; layer names match the flax module's."""

    def __init__(self, max_actions: int, width: int = 256,
                 in_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        A = max_actions
        self.max_actions = A
        self.width = width
        din = in_channels * A * A
        self.policy_fc0 = nn.Linear(din, width)
        self.policy_fc1 = nn.Linear(width, A)
        self.value_fc0 = nn.Linear(din, width)
        self.value_fc1 = nn.Linear(width, 1)
        with torch.no_grad():
            for name in _LAYERS:
                layer = getattr(self, name)
                bound = 1.0 / layer.in_features ** 0.5
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, C, A, A) observations -> (logits (N, A), values (N,))."""
        x = obs.reshape(obs.shape[0], -1)
        logits = self.policy_fc1(torch.relu(self.policy_fc0(x)))
        value = self.value_fc1(torch.relu(self.value_fc0(x)))
        return logits, value[:, 0]


def build_net(config: NetConfig,
              generator: Optional[torch.Generator] = None) -> MLP:
    if config.type != "MLP":
        raise NotImplementedError(
            f"NetConfig.type: the port runs the MLP only, got {config.type!r}")
    if config.depth != 1:
        raise NotImplementedError(
            f"NetConfig.depth: the port runs depth-1 MLPs only, got "
            f"{config.depth}")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"NetConfig.compute_dtype: the port computes in float32, got "
            f"{config.compute_dtype!r}")
    return MLP(config.max_actions, config.width, generator=generator)


def params_from_flax(np_params: Dict[str, Dict[str, np.ndarray]]
                     ) -> Dict[str, torch.Tensor]:
    """flax ``params`` ({layer: {kernel (in, out), bias}}) -> a state_dict
    for :class:`MLP` (weight (out, in))."""
    state = {}
    for name in _LAYERS:
        layer = np_params[name]
        state[f"{name}.weight"] = torch.as_tensor(
            np.array(layer["kernel"]).T.copy())
        state[f"{name}.bias"] = torch.as_tensor(np.array(layer["bias"]))
    return state


def params_to_flax(module: MLP) -> Dict[str, Dict[str, np.ndarray]]:
    """:class:`MLP` -> flax-layout ``params`` of numpy arrays."""
    return {name: {"kernel": getattr(module, name).weight.detach().cpu()
                   .numpy().T.copy(),
                   "bias": getattr(module, name).bias.detach().cpu().numpy()
                   .copy()}
            for name in _LAYERS}


def mlp_fused_weights(net: MLP) -> Tuple[torch.Tensor, ...]:
    """Both heads as one fused pair: W0 = [policy_fc0 | value_fc0]
    (din, 2W), b0 (2W,); W1 (2W, A+1) block-diagonal, mapping the policy
    half to the A logits and the value half to column A; b1 (A+1,)."""
    A, W = net.max_actions, net.width
    w0 = torch.cat([net.policy_fc0.weight.t(), net.value_fc0.weight.t()], 1)
    b0 = torch.cat([net.policy_fc0.bias, net.value_fc0.bias])
    w1 = torch.zeros((2 * W, A + 1), dtype=w0.dtype, device=w0.device)
    w1[:W, :A] = net.policy_fc1.weight.t()
    w1[W:, A] = net.value_fc1.weight[0]
    b1 = torch.cat([net.policy_fc1.bias, net.value_fc1.bias])
    return w0.contiguous(), b0, w1, b1


def mlp_head_eval(net: MLP, obs_flat: torch.Tensor,
                  head: str) -> torch.Tensor:
    """One head's forward: ``logits (N, A)`` for ``head="policy"`` or
    ``values (N,)`` for ``head="value"``.  The heads share nothing, so a
    consumer of one head skips the other's matmuls (the learner's frozen
    passes need only the target's value and the reg nets' policies)."""
    x = obs_flat.reshape(obs_flat.shape[0], -1)
    fc0 = getattr(net, f"{head}_fc0")
    fc1 = getattr(net, f"{head}_fc1")
    out = fc1(torch.relu(fc0(x)))
    return out[:, 0] if head == "value" else out
