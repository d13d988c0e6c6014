"""Typed configuration objects; the port's own copy of ``rnad_tpu/config.py``.

The port cannot import ``rnad_tpu.config``: importing it runs
``rnad_tpu/__init__.py``, which pulls in jax.  So the five dataclasses are
copied here with the same fields, defaults and JSON form (a test holds them
equal).  The rationale of each field is documented at its counterpart in
``rnad_tpu/config.py``.

Fields whose behaviour the port does not implement yet keep their defaults;
``learn/rnad.py::RNaD`` raises ``NotImplementedError`` for any other value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShapingRule:
    """``new = old + delta + (u < stochastic_prob) * stochastic_delta`` with
    ``u ~ U[0, 1)`` drawn per child (replaces the reference's lambdas)."""

    delta: int = 0
    stochastic_delta: int = 0
    stochastic_prob: float = 0.0

    def apply(self, value: np.ndarray, u: np.ndarray) -> np.ndarray:
        out = value + self.delta
        if self.stochastic_prob > 0.0 and self.stochastic_delta != 0:
            out = out + (u < self.stochastic_prob) * self.stochastic_delta
        return out

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShapingRule":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Parameters of the random stochastic matrix-tree game."""

    max_actions: int = 3
    max_transitions: int = 1
    depth_bound: int = 1
    row_actions: Optional[int] = None  # defaults to max_actions
    col_actions: Optional[int] = None
    transition_threshold: float = 0.0
    terminal_values: Tuple[float, ...] = (-1.0, 1.0)
    row_actions_rule: ShapingRule = ShapingRule()
    col_actions_rule: ShapingRule = ShapingRule()
    depth_bound_rule: ShapingRule = ShapingRule(delta=-1)
    # The port stores the simplex vertex only ("vertex").
    equilibrium_selection: str = "vertex"
    desc: str = ""

    def root_row_actions(self) -> int:
        return self.row_actions if self.row_actions is not None else self.max_actions

    def root_col_actions(self) -> int:
        return self.col_actions if self.col_actions is not None else self.max_actions

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["terminal_values"] = list(self.terminal_values)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TreeConfig":
        d = dict(d)
        d["terminal_values"] = tuple(d["terminal_values"])
        for k in ("row_actions_rule", "col_actions_rule", "depth_bound_rule"):
            d[k] = ShapingRule.from_json(d[k])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ObsTransformConfig:
    """Noisy high-dimensional observation transform
    (``ops/obs_transform.py``).  ``kind="lift"``: each half-step
    observation becomes ``channels`` seeded, mixed, biased views of the
    payoff and legal matrices plus fresh Gaussian noise of std ``sigma``;
    the raw legal matrix rides along at channel 1."""

    kind: str = "none"  # "none" | "lift"
    channels: int = 8  # lifted channels (net input channels = this + 1)
    sigma: float = 0.1  # per-half-step Gaussian noise std
    bias_scale: float = 1.0  # scale of the fixed random spatial bias field
    seed: int = 0  # the transform's own parameter seed

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ObsTransformConfig":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Network architecture selection (the port runs the depth-1 MLP and
    the EquiNet, each in float32 or bfloat16, and the float32 ConvNet)."""

    type: str = "MLP"  # "MLP" | "ConvNet" | "EquiNet"
    max_actions: int = 3
    width: int = 256  # MLP hidden width
    channels: int = 16  # ConvNet / EquiNet channels
    depth: int = 1  # ConvNet residual tower / MLP hidden / EquiNet layers
    batch_norm: bool = True  # ConvNet only
    solver_iters: int = 0  # EquiNet only
    solver_prime: bool = False  # EquiNet only
    compute_dtype: str = "float32"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "NetConfig":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class RNaDConfig:
    """Hyperparameters of the R-NaD trainer (``logit_clip`` is the NeuRD
    logit threshold ``beta``, not an activation clamp)."""

    batch_size: int = 3 * 2**8
    eta: float = 0.2
    bounds: Tuple[int, ...] = (100, 165, 200)
    delta_m: Tuple[int, ...] = (10_000, 100_000, 35_000)
    lr: float = 5e-5
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_final_fraction: float = 0.0
    logit_clip: float = 2.0
    neurd_clip: float = 1e3
    grad_clip: float = 1e3
    b1_adam: float = 0.0
    b2_adam: float = 0.999
    epsilon_adam: float = 1e-8
    gamma_averaging: float = 0.001
    roh_bar: float = 1.0
    c_bar: float = 1.0
    epsilon_threshold: float = 0.03
    n_discrete: int = 32
    n_batches_per_buffer: int = 1  # 1 == degenerate on-policy buffer
    buffer_mod: int = 1
    vtrace_gamma: float = 1.0
    value_loss_weight: float = 1.0
    neurd_loss_weight: float = 1.0
    policy_warmup_steps: int = 0
    nashconv_chunk_nodes: int = 200_000
    vtrace_mode: str = "auto"
    frozen_net_dtype: str = "float32"
    # Every mode computes the same losses.  The port runs "heads" for the
    # MLP ("auto", "heads", "frozen", "all") and "off" for the EquiNet
    # ("auto", "off"); learn/rnad.py::resolve_fuse_mode raises as rnad_tpu
    # does on the other pairs.
    fuse_net_passes: str = "auto"
    detailed_metrics: bool = True
    # True: the rollout stores each half-step's observation (K1 writes the
    # raw ones, the generic turn keeps its batch) and the learner reads
    # them; False: the learner regathers them (K2).  Both give bitwise the
    # same updates on raw observations; an obs_transform requires True.
    store_rollout_obs: bool = True
    rollout_rows_actor: str = "auto"
    rollout_actor_dtype: str = "float32"
    learner_layout: str = "auto"
    flat_optimizer: bool = False
    reg_anchor: str = "target"
    obs_transform: ObsTransformConfig = ObsTransformConfig()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["bounds"] = list(self.bounds)
        d["delta_m"] = list(self.delta_m)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "RNaDConfig":
        d = dict(d)
        d["bounds"] = tuple(d["bounds"])
        d["delta_m"] = tuple(d["delta_m"])
        if "obs_transform" in d:
            d["obs_transform"] = ObsTransformConfig.from_json(
                d["obs_transform"])
        return cls(**d)
