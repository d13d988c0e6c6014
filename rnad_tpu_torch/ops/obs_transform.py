"""High-dimensional noisy observation transform (the "lift").

Counterpart of ``rnad_tpu/ops/obs_transform.py``.  A raw seat observation
(..., 2, A, A) ([expected value | legal], ``ops/stepping.py::
seat_observations``) becomes (..., C + 1, A, A):

    lifted[c] = sum_d mix[c, d] * raw[d] + bias[c] + sigma * eps[c]
    out = [lifted[0], legal, lifted[1], ..., lifted[C - 1]]

``mix`` (C, 2) and ``bias`` (C, A, A) are fixed by ``ObsTransformConfig.
seed``; ``eps`` is fresh unit Gaussian noise per half-step and lane, which
the caller passes in (``noise=None`` is the noise-free lift that exact
evaluation scores).  Channel 1 stays the raw legal matrix, so every mask
consumer reads ``obs[..., 1, :, 0]`` in both conventions.

``rnad_tpu`` draws ``(mix, bias)`` with ``jax.random``, which torch cannot
replay: the port draws them from ``cfg.seed`` with its own CPU
``torch.Generator``, at ``rnad_tpu``'s shapes and scales (mix ~ N(0, 1) /
sqrt(2), bias ~ ``bias_scale`` * N(0, 1)).  So the same config lifts to
another (equally distributed) transform in each package, as the same seed
initializes another net; ``transform_from_arrays`` carries ``rnad_tpu``'s
pair across for the parity tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import ObsTransformConfig


def out_channels(cfg: ObsTransformConfig) -> int:
    """Channel count of transformed observations (raw observations have
    2)."""
    if cfg.kind == "none":
        return 2
    return cfg.channels + 1


def _check(cfg: ObsTransformConfig) -> None:
    if cfg.kind != "lift":
        raise ValueError(f"unknown obs transform kind {cfg.kind!r}; "
                         "expected 'none' or 'lift'")
    if cfg.channels < 1:
        raise ValueError(f"obs transform needs channels >= 1, got "
                         f"{cfg.channels}")


@dataclasses.dataclass
class ObsTransform:
    """The lift of one config: ``apply(obs, noise=None)``."""

    mix: torch.Tensor  # (C, 2) f32
    bias: torch.Tensor  # (C, A, A) f32
    sigma: float

    @property
    def channels(self) -> int:
        return self.mix.shape[0]

    def to(self, device) -> "ObsTransform":
        return dataclasses.replace(self, mix=self.mix.to(device),
                                   bias=self.bias.to(device))

    def apply(self, obs: torch.Tensor,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., 2, A, A) raw observations -> (..., C + 1, A, A).  ``noise``
        is the (..., C, A, A) unit Gaussian of this call, or None for the
        noise-free lift."""
        A = self.bias.shape[-1]
        if tuple(obs.shape[-3:]) != (2, A, A):
            raise ValueError(f"expected raw (..., 2, {A}, {A}) observations,"
                             f" got {tuple(obs.shape)}")
        mix, bias = self.mix.to(obs.device), self.bias.to(obs.device)
        lifted = torch.einsum("cd,...dij->...cij", mix, obs.float()) + bias
        if noise is not None and self.sigma > 0.0:
            lifted = lifted + self.sigma * noise
        legal = obs[..., 1:2, :, :].float()
        # channel 1 stays the legal matrix: [lift_0, legal, lift_1, ...]
        return torch.cat([lifted[..., :1, :, :], legal, lifted[..., 1:, :, :]],
                         dim=-3)


def transform_params(cfg: ObsTransformConfig, max_actions: int):
    """The port's ``(mix (C, 2), bias (C, A, A))`` of ``cfg``, drawn from
    ``cfg.seed`` on the CPU."""
    if cfg.kind != "lift":
        raise ValueError("transform_params is defined for kind='lift' only")
    A = max_actions
    gen = torch.Generator().manual_seed(cfg.seed)
    mix = torch.randn((cfg.channels, 2), generator=gen) / math.sqrt(2.0)
    bias = cfg.bias_scale * torch.randn((cfg.channels, A, A), generator=gen)
    return mix, bias


def make_obs_transform(cfg: ObsTransformConfig, max_actions: int
                       ) -> Optional[ObsTransform]:
    """The transform of ``cfg``, or None for the raw observation; raises
    ``rnad_tpu``'s errors on an unknown kind and on ``channels < 1``."""
    if cfg.kind == "none":
        return None
    _check(cfg)
    mix, bias = transform_params(cfg, max_actions)
    return ObsTransform(mix=mix, bias=bias, sigma=cfg.sigma)


def transform_from_arrays(cfg: ObsTransformConfig, mix: np.ndarray,
                          bias: np.ndarray) -> ObsTransform:
    """The lift of ``cfg`` with a given ``(mix, bias)`` pair, such as
    ``rnad_tpu``'s ``transform_params`` (as numpy)."""
    _check(cfg)
    return ObsTransform(mix=torch.tensor(np.asarray(mix, np.float32)),
                        bias=torch.tensor(np.asarray(bias, np.float32)),
                        sigma=cfg.sigma)
