"""R-NaD trainer: the fused on-policy train step, the buffered (off-policy)
step and the host schedule loop.

Counterpart of ``rnad_tpu/learn/rnad.py``.  One train step runs, in order:
the rollout (per turn, one fused-turn kernel launch for the MLP on raw
observations, or the generic turn: a packed-row lookup, the observation
lift where configured, the net forward and, for a solver EquiNet, one RM+
kernel launch), the learner's forward with autograd on the regathered
observations (one packed-row lookup, and one RM+ solve shared by all four
passes) or on the stored lifted ones, the frozen passes, the
alpha-interpolated reward transform and two-player v-trace, the NeuRD and
critic losses, the optax global-norm clip, Adam with the optax formulas
(b1=0 by default) and the EMA target update.  The net passes follow
``fuse_net_passes``: "heads" (the MLP: the EMA target's value head and the
regularization pair's policy heads) or "off" (each frozen net's whole
forward; "auto" for every other net).  The frozen passes compute in
``frozen_net_dtype`` where it is bfloat16 (the nets' float32 weights cast
per layer, as ``rnad_tpu``'s ``net.clone(dtype=...)`` does) and in the
net's own dtype otherwise.  The policies, the v-trace and the losses run
in the (T, B, A) layout, and ``flat_optimizer`` runs the clip + Adam + EMA
tail on one raveled vector (``flat_optimizer_update``,
``flat_ema_update``) where ``rnad_tpu``'s ``use_flat`` rule allows it,
bitwise the per-leaf tail.  The port does not run ``rnad_tpu``'s
batch-minor ``learner_layout="amb"``, which exists for the TPU's 128-lane
tile, nor its packed ``fuse_net_passes`` "frozen" and "all", which lost to
"heads" on the TPU and on the H100; ``check_supported`` refuses them.  The
``RNaD`` host loop owns the run's lifecycle (a fresh start or a bit-exact
resume from the run store), the (m, n, alpha) schedule, regularization
rotation (``reg_anchor`` "target", "best" or "fixed"), checkpoints, exact
NashConv at update boundaries (chunked on large trees) with best-checkpoint
selection, and the metric log (``metrics.jsonl`` and ``RNaD.history``).

A ConvNet's learner pass runs its BatchNorm in train mode over the valid
half-steps and moves the running averages; the rollout actor, the frozen
passes and NashConv read running averages (the mode is an argument of each
forward, so no module state carries from one phase into the next).  The EMA
target averages the BatchNorm statistics with the weights; Adam sees the
weights only.  Under data parallelism the learner's BatchNorm has two
semantics, named by ``learn_step``'s ``batch_norm``: "global" (the
global-stream path, ``rnad_tpu``'s GSPMD step: statistics over the global
batch) and "per_rank" (the per-rank-stream path, ``rnad_tpu``'s non-sync
shard_map step: each rank's own statistics, the running averages then
averaged over the ranks).

With ``n_batches_per_buffer`` or ``buffer_mod`` above 1, ``RNaD.run`` keeps
a replay buffer (``learn/buffer.py``): a fresh rollout when the buffer is
empty or the step count is a multiple of ``buffer_mod``, then one learner
step on lanes sampled across the buffered batches.

The step updates the ``TrainState`` in place (parameters, Adam moments and
the EMA target) instead of building new tensors.

While a ``torch.profiler`` session records, the step's layers are spans on
its timeline (``utils/timing.py::span``): ``rnad.train_step`` holds
``rnad.rollout`` and ``rnad.learn``, and the learner, in order,
``rnad.learn.forward``, ``.frozen`` (it holds ``rnad.learn.frozen.fused``
where kernel K4 runs the three frozen bf16 EquiNets), ``.vtrace``,
``.backward``, ``.allreduce`` (under a group) and ``.update``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import NetConfig, RNaDConfig
from ..env import engine
from ..env.tree import GameTree
from ..metrics import nashconv as nashconv_lib
from ..metrics import nashconv_shard
from ..models import common, nets
from ..ops import equinet as equinet_ops
from ..ops import obs_transform as obs_transform_lib
from ..ops import stepping
from ..parallel import tensor_parallel
from ..parallel.mesh import DataGroup, Grid
from ..utils import timing
from ..utils.checkpoint import RunStore
from ..utils.logging import MetricLogger
from . import buffer as buffer_lib
from . import vtrace, vtrace_assoc


@dataclasses.dataclass
class AdamState:
    """Adam moments per parameter (``net.parameters()`` order) and the step
    count, as optax's ``ScaleByAdamState``."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


@dataclasses.dataclass
class TrainState:
    """The four nets of ``rnad_tpu``'s ``TrainState`` (learner, EMA target,
    regularization pair), the optimizer state, the rollout noise generator
    and the step counter."""

    net: nn.Module  # learner (rnad_tpu: variables)
    net_target: nn.Module  # EMA target (variables_target)
    net_reg: nn.Module  # pi_reg (variables_reg)
    net_reg_: nn.Module  # pi_reg_prev (variables_reg_)
    opt: AdamState
    generator: torch.Generator  # rollout Gumbel noise
    total_steps: int = 0


def _frozen_copy(net: nn.Module) -> nn.Module:
    out = copy.deepcopy(net)
    out.requires_grad_(False)
    return out


def init_train_state(net: nn.Module, generator: torch.Generator
                     ) -> TrainState:
    """All four nets start as copies of ``net``; Adam moments are zero."""
    params = list(net.parameters())
    return TrainState(
        net=net, net_target=_frozen_copy(net), net_reg=_frozen_copy(net),
        net_reg_=_frozen_copy(net),
        opt=AdamState(mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params]),
        generator=generator)


def learning_rate(cfg: RNaDConfig, count: int) -> float:
    """The learning rate of the update whose Adam count before the increment
    is ``count``.  "cosine" is ``optax.cosine_decay_schedule(lr,
    lr_decay_steps, alpha=lr_final_fraction)`` in its float32 operation
    order, the cosine taken in float64 and rounded (within an ulp of
    XLA's), so it reaches ``lr * lr_final_fraction`` at ``lr_decay_steps``
    and stays there."""
    if cfg.lr_schedule == "constant":
        return cfg.lr
    f32 = np.float32
    t = f32(min(count, cfg.lr_decay_steps))
    x = f32(np.pi) * t / f32(cfg.lr_decay_steps)
    decay = f32(0.5) * (f32(1) + f32(math.cos(float(x))))
    alpha = cfg.lr_final_fraction
    return float(f32(cfg.lr) * (f32(1 - alpha) * decay + f32(alpha)))


def _clip(g: torch.Tensor, g_norm: torch.Tensor, clip: float
          ) -> torch.Tensor:
    return torch.where(g_norm < clip, g, g / g_norm * clip)


@torch.no_grad()
def optimizer_update(cfg: RNaDConfig, params: List[torch.Tensor],
                     grads: List[torch.Tensor], opt: AdamState,
                     g_norm: Optional[torch.Tensor] = None) -> None:
    """optax ``chain(clip_by_global_norm, adam)`` written out, in place.

    The global norm (``g_norm``, default ``global_norm(grads)``) is the
    optax per-leaf sum of squares; a norm at or above the clip scales by
    ``clip / norm`` (no epsilon, unlike ``clip_grad_norm_``).  Adam is
    ``mu_hat / (sqrt(nu_hat) + eps)`` with optax's bias correction
    computed in float32, scaled by ``learning_rate`` at the count before
    this update."""
    if g_norm is None:
        g_norm = global_norm(grads)
    grads = [_clip(g, g_norm, cfg.grad_clip) for g in grads]
    adam_update(params, grads, opt, learning_rate(cfg, opt.count),
                cfg.b1_adam, cfg.b2_adam, cfg.epsilon_adam)


def _ravel(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unravel_into(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copies the consecutive slices of ``flat`` into ``tensors``."""
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t)
                                   for p, t in zip(parts, tensors)])


@torch.no_grad()
def flat_optimizer_update(cfg: RNaDConfig, params: List[torch.Tensor],
                          grads: List[torch.Tensor], opt: AdamState,
                          g_norm: Optional[torch.Tensor] = None) -> None:
    """``optimizer_update`` on one raveled vector (``rnad_tpu``'s
    ``flat_optimizer_update``): the gradients, weights and moments are
    concatenated, the clip and Adam run once over the (P,) vectors and the
    results are copied back into the leaves, so Adam's state keeps its
    per-leaf layout.  The global norm keeps ``global_norm``'s per-leaf
    order and every other operation is elementwise with
    ``optimizer_update``'s formulas, so the result is bitwise the per-leaf
    update.  For the constant learning rate (``uses_flat_optimizer``)."""
    if g_norm is None:
        g_norm = global_norm(grads)
    g = _clip(_ravel(grads), g_norm, cfg.grad_clip)
    p, mu, nu = _ravel(params), _ravel(opt.mu), _ravel(opt.nu)
    flat = AdamState([mu], [nu], opt.count)
    adam_update([p], [g], flat, cfg.lr, cfg.b1_adam, cfg.b2_adam,
                cfg.epsilon_adam)
    opt.count = flat.count
    for leaves, flat in ((params, p), (opt.mu, mu), (opt.nu, nu)):
        _unravel_into(leaves, flat)


@torch.no_grad()
def global_norm(grads: List[torch.Tensor],
                net: Optional[nn.Module] = None) -> torch.Tensor:
    """optax's global norm: the square root of the per-leaf sums of
    squares, added in leaf order.  For a tensor-parallel ``net`` (whose
    parameters ``grads`` are) each sharded leaf's sum is first summed over
    the model axis, and each replicated leaf counted once."""
    squares = [(g * g).sum() for g in grads]
    if net is not None:
        squares = tensor_parallel.model_sums(net, squares)
    return torch.sqrt(sum(squares))


@torch.no_grad()
def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                opt: AdamState, lr: float, b1: float, b2: float,
                eps: float) -> None:
    """optax ``adam(lr, b1, b2, eps)``'s update and ``apply_updates``, in
    place, in optax's operation order."""
    opt.count += 1
    # host scalars holding the float32 values optax computes on device
    corr1 = float(np.float32(1) - np.float32(b1) ** np.int32(opt.count))
    corr2 = float(np.float32(1) - np.float32(b2) ** np.int32(opt.count))
    for p, g, mu, nu in zip(params, grads, opt.mu, opt.nu):
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / corr1
        nu_hat = nu / corr2
        p.add_((-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps)))


def _ema_tensors(net: nn.Module) -> List[torch.Tensor]:
    """What the EMA averages: the weights, then the floating buffers
    (BatchNorm statistics)."""
    return list(net.parameters()) + [b for b in net.buffers()
                                     if b.is_floating_point()]


@torch.no_grad()
def ema_update(gamma: float, net: nn.Module, net_target: nn.Module
               ) -> None:
    """target <- gamma * learner + (1 - gamma) * target, in place, over the
    weights and the floating buffers (BatchNorm statistics) alike."""
    for p, t in zip(_ema_tensors(net), _ema_tensors(net_target)):
        t.copy_(gamma * p + (1.0 - gamma) * t)


@torch.no_grad()
def flat_ema_update(gamma: float, net: nn.Module, net_target: nn.Module
                    ) -> None:
    """``ema_update`` on one raveled vector (``rnad_tpu``'s
    ``flat_ema_update``), bitwise the per-leaf update."""
    target = _ema_tensors(net_target)
    t = _ravel(target)
    _unravel_into(target, gamma * _ravel(_ema_tensors(net))
                  + (1.0 - gamma) * t)


def uses_flat_optimizer(cfg: RNaDConfig, state: "TrainState") -> bool:
    """``rnad_tpu``'s ``use_flat`` rule: ``flat_optimizer`` with the
    constant learning rate, every weight and averaged buffer of the learner
    and the target (and so every gradient) float32."""
    return (cfg.flat_optimizer and cfg.lr_schedule == "constant"
            and all(t.dtype == torch.float32
                    for net in (state.net, state.net_target)
                    for t in _ema_tensors(net)))


def apply_update(cfg: RNaDConfig, state: "TrainState",
                 grads: List[torch.Tensor],
                 g_norm: Optional[torch.Tensor] = None) -> None:
    """The step's tail, in place: clip + Adam on the learner's weights,
    then the EMA of the target, on one raveled vector where
    ``uses_flat_optimizer`` and per leaf otherwise."""
    params = list(state.net.parameters())
    if uses_flat_optimizer(cfg, state):
        flat_optimizer_update(cfg, params, list(grads), state.opt, g_norm)
        flat_ema_update(cfg.gamma_averaging, state.net, state.net_target)
    else:
        optimizer_update(cfg, params, list(grads), state.opt, g_norm)
        ema_update(cfg.gamma_averaging, state.net, state.net_target)


def neurd_scale_for(cfg: RNaDConfig, total_steps: int) -> float:
    """Critic-first warmup gate: 0 while ``total_steps <
    policy_warmup_steps``, 1 after."""
    warm = cfg.policy_warmup_steps
    return 1.0 if not warm or total_steps >= warm else 0.0


def resolve_fuse_mode(net: nn.Module, cfg: RNaDConfig) -> str:
    """Resolves ``cfg.fuse_net_passes`` against the net family as
    ``rnad_tpu`` does, with its errors.  "auto" is "heads" for the MLP (the
    only family with separable heads) and "off" otherwise; ``rnad_tpu``'s
    packed modes raise (``check_fuse_mode``)."""
    mode = cfg.fuse_net_passes
    is_mlp = isinstance(net, nets.MLP)
    if mode == "auto":
        return "heads" if is_mlp else "off"
    check_fuse_mode(mode)
    if mode == "heads" and not is_mlp:
        raise ValueError(
            f"fuse_net_passes='heads' requires an MLP (the only family "
            f"with separable heads); got {type(net).__name__}")
    return mode


def check_fuse_mode(mode: str) -> None:
    """Raises ``NotImplementedError`` for ``rnad_tpu``'s packed modes, the
    depth-1 MLP's frozen nets ("frozen") or all four nets ("all") in one
    matmul pair, which lost to "heads" on the TPU (``rnad_tpu/config.py``)
    and on the H100, and ``ValueError`` for an unknown mode."""
    if mode in ("frozen", "all"):
        raise NotImplementedError(
            f"fuse_net_passes: the port runs 'heads' (the MLP) and 'off', "
            f"not {mode!r}, whose packed matmul pair lost to 'heads' on the "
            f"TPU and on the H100; use 'auto'")
    if mode not in ("auto", "heads", "off"):
        raise ValueError(f"unknown fuse_net_passes mode {mode!r}")


def frozen_dtype(net: nn.Module, cfg: RNaDConfig) -> torch.dtype:
    """The dtype of the three frozen passes: ``frozen_net_dtype`` where it
    is not float32, else the net's own (``rnad_tpu`` clones the net only
    for a non-float32 ``frozen_net_dtype``)."""
    if cfg.frozen_net_dtype == "float32":
        return net.dtype
    return nets.DTYPES[cfg.frozen_net_dtype]


@dataclasses.dataclass
class LearnerInputs:
    """What the learner's net passes read: the regathered or stored
    observations (T * B, C, A, A), the movers' legal masks (T, B, A) and,
    for a solver EquiNet, its solver features (one K3 launch), shared by
    all four passes."""

    obs_flat: torch.Tensor
    masks: torch.Tensor
    solver_feats: Optional[Tuple[torch.Tensor, ...]] = None


def learner_inputs(state: TrainState, packed: stepping.PackedTables,
                   traj: engine.Trajectory) -> LearnerInputs:
    """The trajectory's observations (its stored ones, or one K2 regather)
    and, for an EquiNet with solver features, one solve over them."""
    observations, masks = engine.trajectory_observations(packed, traj)
    T, B = traj.rewards.shape
    obs_flat = observations.reshape((T * B,) + observations.shape[2:])
    feats = None
    if isinstance(state.net, nets.EquiNet) and state.net.solver_iters:
        feats = nets.equinet_solver_features(state.net, obs_flat)
    return LearnerInputs(obs_flat=obs_flat, masks=masks, solver_feats=feats)


def learn_loss(state: TrainState, packed: stepping.PackedTables,
               traj: engine.Trajectory, alpha: float, cfg: RNaDConfig,
               neurd_scale: float = 1.0,
               inputs: Optional[LearnerInputs] = None,
               group: Optional[DataGroup] = None,
               batch_norm: str = "global"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of one learner update; differentiable w.r.t. ``state.net``.
    ``inputs`` defaults to ``learner_inputs(state, packed, traj)``.

    Under ``group`` (``rnad_tpu``'s ``axis_name``) ``traj`` is this rank's
    slice of the lanes: every masked mean is this rank's numerator over the
    global valid count (``vtrace.renormalize``), so the loss returned is
    this rank's share of the global loss and the ranks' gradients add up to
    its gradient.  The metrics are global: the losses are summed over the
    ranks, and the diagnostics' counts and extrema reduce over them, so
    every metric equals its unsharded value up to summation order.  A
    ConvNet's BatchNorm normalizes over the global batch where
    ``batch_norm`` is "global" and over this rank's lanes where it is
    "per_rank" (``learn_step``)."""
    fuse = resolve_fuse_mode(state.net, cfg)
    T, B = traj.rewards.shape
    with timing.span("rnad.learn.forward"):
        if inputs is None:
            inputs = learner_inputs(state, packed, traj)
        valid = traj.valid()
        obs_flat, masks = inputs.obs_flat, inputs.masks
        if equinet_ops.trains(state.net, obs_flat, inputs.solver_feats):
            # a bf16 EquiNet on the card: forward on K4, backward on K5
            logits, v_raw = equinet_ops.forward_train(
                state.net, obs_flat, inputs.solver_feats)
        else:
            logits, v_raw = nets.forward_train(
                state.net, obs_flat, valid.reshape(T * B),
                inputs.solver_feats,
                group if batch_norm == "global" else None)
    with torch.no_grad(), timing.span("rnad.learn.frozen"):
        frozen = _frozen_passes(state, cfg, fuse, obs_flat,
                                inputs.solver_feats)
    with timing.span("rnad.learn.vtrace"):
        return _losses(traj, alpha, cfg, neurd_scale, group, valid, masks,
                       logits, v_raw, frozen)


def _frozen_passes(state: TrainState, cfg: RNaDConfig, fuse: str,
                   obs_flat: torch.Tensor, solver_feats) -> Tuple:
    """The frozen nets' passes the loss reads under ``fuse`` "heads" or
    "off": (the target's logits, its values, the reg net's logits, the
    previous reg net's logits); the target's logits are None under "heads"
    without ``detailed_metrics``.  Under "off", bf16 EquiNets on the card
    that kernel K4 takes (``ops/equinet.py``'s ``unsupported`` names
    nothing) run as one launch; every other net runs its forwards."""
    dtype = frozen_dtype(state.net, cfg)
    if fuse == "heads":
        # the target contributes its value, the reg pair their policies;
        # the target's policy feeds one diagnostic only
        head = lambda net, h: net.head(obs_flat, h, dtype)
        values_target = head(state.net_target, "value")
        logits_reg = head(state.net_reg, "policy")
        logits_reg_prev = head(state.net_reg_, "policy")
        logits_t = (head(state.net_target, "policy")
                    if cfg.detailed_metrics else None)
        return logits_t, values_target, logits_reg, logits_reg_prev
    # "off": every frozen net's whole forward; bf16 EquiNets' in one
    # kernel launch (K4) on the card
    frozen = (state.net_target, state.net_reg, state.net_reg_)
    if equinet_ops.unsupported(frozen, obs_flat, solver_feats, dtype) is None:
        with timing.span("rnad.learn.frozen.fused"):
            (logits_t, values_target), (logits_reg, _), (
                logits_reg_prev, _) = equinet_ops.equinet_frozen(
                    frozen, obs_flat, solver_feats, dtype,
                    values=(True, False, False))
        return logits_t, values_target, logits_reg, logits_reg_prev
    logits_t, values_target = state.net_target(obs_flat, solver_feats,
                                               dtype=dtype)
    logits_reg, _ = state.net_reg(obs_flat, solver_feats, dtype=dtype)
    logits_reg_prev, _ = state.net_reg_(obs_flat, solver_feats, dtype=dtype)
    return logits_t, values_target, logits_reg, logits_reg_prev


def _losses(traj: engine.Trajectory, alpha: float, cfg: RNaDConfig,
            neurd_scale: float, group: Optional[DataGroup],
            valid: torch.Tensor, masks: torch.Tensor, logits: torch.Tensor,
            v_raw: torch.Tensor, frozen: Tuple
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``learn_loss`` from the net passes on: the learner's and the frozen
    nets' policies, the two-player v-trace, both losses and the
    diagnostics."""
    gsum = group.global_sum if group is not None else None
    logits_t, values_target, logits_reg, logits_reg_prev = frozen
    player_id = traj.turns
    T, B = traj.rewards.shape
    A = traj.num_actions
    # alpha and 1 - alpha rounded as float32, as rnad_tpu computes them
    alpha_f32 = np.float32(alpha)
    alpha, one_minus_alpha = float(alpha_f32), float(np.float32(1) - alpha_f32)

    logits = logits.reshape(T, B, A)
    v = v_raw.reshape(T, B)[..., None]
    pi = common.masked_policy(logits, masks)
    log_pi = common.masked_log_policy(logits, masks)

    with torch.no_grad():
        tba = lambda x: x.reshape(T, B, A)
        v_target_net = values_target.reshape(T, B)[..., None]
        log_pi_reg = common.masked_log_policy(tba(logits_reg), masks)
        log_pi_reg_prev = common.masked_log_policy(tba(logits_reg_prev),
                                                   masks)
        pi_target = (common.masked_policy(tba(logits_t), masks)
                     if cfg.detailed_metrics else None)

        pi_processed = vtrace.process_policy(
            pi.detach(), masks, cfg.n_discrete, cfg.epsilon_threshold)
        log_policy_reg = log_pi.detach() - (
            alpha * log_pi_reg + one_minus_alpha * log_pi_reg_prev)
        acting_policy = traj.policy
        vt_both = (vtrace_assoc.v_trace_both_assoc
                   if cfg.vtrace_mode == "associative"
                   else vtrace.v_trace_both)
        v_t2, played2, pol_t2 = vt_both(
            v_target_net, valid, player_id, acting_policy, pi_processed,
            log_policy_reg, traj.actions_oh(), traj.rewards,
            eta=cfg.eta, lambda_=1.0, c=cfg.c_bar, rho=cfg.roh_bar,
            gamma=cfg.vtrace_gamma)

    loss_v = vtrace.get_loss_v([v, v], [v_t2[0], v_t2[1]],
                               [played2[0], played2[1]], gsum)
    is_vector = torch.ones_like(valid)[..., None]
    loss_nerd = vtrace.get_loss_nerd(
        [logits, logits], [pi_processed, pi_processed],
        [pol_t2[0], pol_t2[1]], valid, player_id, masks,
        [is_vector, is_vector], clip=cfg.neurd_clip,
        threshold=cfg.logit_clip, global_sum=gsum)
    loss = (cfg.value_loss_weight * loss_v
            + neurd_scale * cfg.neurd_loss_weight * loss_nerd)

    metrics = {"loss": loss.detach(), "loss_v": loss_v.detach(),
               "loss_nerd": loss_nerd.detach()}
    if not cfg.detailed_metrics:
        if gsum is not None:  # the ranks' shares add up to the global losses
            metrics = dict(zip(metrics, gsum(torch.stack(list(
                metrics.values())))))
        return loss, metrics
    with torch.no_grad():
        uniform_policy = masks / torch.clamp(
            masks.sum(-1, keepdim=True), min=1e-30)
        klds = {"entropy": (pi, uniform_policy),
                "entropy_target": (pi_target, uniform_policy),
                "actor_learner_kld": (pi, acting_policy)}
        if gsum is None:
            logit_mean = logits.mean()
            metrics.update({
                "traj_len": valid.sum(0).mean(),
                "logit_mean": logit_mean,
                "logit_max": (logits - logit_mean).abs().max()})
            metrics.update({k: nashconv_lib.kld(p, q, valid, masks)
                            for k, (p, q) in klds.items()})
            return loss, metrics
        # one all-reduce of the losses' shares and every diagnostic's
        # numerator and count, then one of the extremum
        parts = [*metrics.values(), logits.sum(),
                 logits.new_tensor(float(logits.numel())), valid.sum(),
                 valid.new_tensor(float(B))]
        for p, q in klds.values():
            parts.extend(nashconv_lib.kld_sums(p, q, valid, masks))
        sums = gsum(torch.stack(parts))
        metrics = dict(zip(metrics, sums[:3]))
        logit_mean = sums[3] / sums[4]
        metrics.update({
            "traj_len": sums[5] / sums[6],
            "logit_mean": logit_mean,
            "logit_max": group.global_max((logits - logit_mean).abs().max())})
        for i, k in enumerate(klds):
            total, count = sums[7 + 2 * i], sums[8 + 2 * i]
            metrics[k] = total / torch.clamp(count, min=1.0)
    return loss, metrics


def obs_storage_dtype(net: nn.Module, cfg: RNaDConfig) -> torch.dtype:
    """Stored-observation dtype: the net's compute dtype promoted with
    ``frozen_net_dtype``, so every learner-side consumer sees the bits it
    would from float32 observations."""
    return torch.promote_types(net.dtype, nets.DTYPES[cfg.frozen_net_dtype])


def resolve_obs_transform(net_config: NetConfig, tree: GameTree,
                          cfg: RNaDConfig
                          ) -> Optional[obs_transform_lib.ObsTransform]:
    """The observation transform of ``cfg`` on the tree's device, or None;
    raises ``rnad_tpu``'s errors where it cannot compose: with
    ``store_rollout_obs=False`` (the noise cannot be re-derived from state
    indices) and with a solver EquiNet (its features read the raw payoff
    matrix the lift hides)."""
    tf = obs_transform_lib.make_obs_transform(cfg.obs_transform,
                                              tree.max_actions)
    if tf is None:
        return None
    if not cfg.store_rollout_obs:
        raise ValueError(
            "obs_transform requires store_rollout_obs=True: per-half-step "
            "noise cannot be re-derived from state indices in regather "
            "mode, so the learner must consume the stored actor bits")
    if net_config.type == "EquiNet" and net_config.solver_iters:
        raise ValueError(
            "obs_transform hides the raw payoff matrix, but EquiNet with "
            "solver_iters > 0 computes RM+ solver features from it; use "
            "solver_iters=0 or another net family")
    return tf.to(tree.device)


def rollout(state: TrainState, tree: GameTree, packed: stepping.PackedTables,
            cfg: RNaDConfig, noise=None,
            obs_transform: Optional[obs_transform_lib.ObsTransform] = None
            ) -> engine.Trajectory:
    """The training rollout: ``batch_size`` episodes from the root, storing
    the observations where ``store_rollout_obs`` says (the lifted ones
    under ``obs_transform`` always)."""
    with timing.span("rnad.rollout"):
        init = torch.ones((cfg.batch_size,), dtype=torch.int32,
                          device=packed.rows.device)
        return engine.rollout_from(
            tree, packed, state.net, init, tree.max_depth, noise=noise,
            generator=state.generator, rows_actor=cfg.rollout_rows_actor,
            obs_transform=obs_transform, store_obs=cfg.store_rollout_obs,
            obs_dtype=obs_storage_dtype(state.net, cfg),
            actor_dtype=nets.DTYPES[cfg.rollout_actor_dtype])


def learn_step(state: TrainState, packed: stepping.PackedTables,
               traj: engine.Trajectory, alpha: float, cfg: RNaDConfig,
               group: Optional[DataGroup] = None,
               batch_norm: str = "global") -> Dict[str, torch.Tensor]:
    """One learner update on ``traj``: loss, gradients, clip + Adam, EMA.

    Under ``group`` ``traj`` is this rank's slice of the lanes, and the
    gradients are summed over the ranks (one ``all_reduce``) before the
    gradient norm, the clip and Adam, so every rank applies the same
    update to the same weights and they stay bitwise replicated.  This is
    the port's form of ``rnad_tpu``'s psum-then-pmean
    (``shard_map_step.py:66-77``): there the transpose of the in-loss psum
    multiplies each shard's gradient by the axis size n and pmean divides
    by n; here each rank's loss is already its numerator over the global
    count (``learn_loss``), so the SUM is the unsharded gradient itself.

    With tensor-parallel nets (``parallel/tensor_parallel.py``) ``group``
    is the data axis of the grid: each rank holds its shards of the
    weights and of Adam's moments, every rank of a model row computes the
    same loss, and autograd gives it its shards' gradients and the whole
    gradients of the replicated weights (equal across the row).  They are
    summed over the data axis only (a sum over the world would count each
    model row m times), and the global norm sums the sharded leaves'
    squares over the model axis (``global_norm``).  Adam and the EMA act
    elementwise on the shards.

    ``batch_norm`` names a ConvNet's BatchNorm semantic under ``group``
    (the caller's choice; it changes nothing without a group or a
    BatchNorm):

    * "global" (``parallel/runtime.py``, ``rnad_tpu``'s GSPMD step): the
      statistics are the global batch's (``MaskedBatchNorm`` under a
      group), so every rank moves its running averages alike and they are
      left as they are: averaging equal buffers, (x + x + x) / 3, need not
      round back to x.
    * "per_rank" (``parallel/shard_map_step.py``, ``rnad_tpu``'s non-sync
      shard_map step): each rank normalizes by its own lanes, and the
      running averages are then averaged over the ranks (SUM / world,
      ``pmean``), so every rank carries the same buffers into the EMA
      target."""
    if batch_norm not in ("global", "per_rank"):
        raise ValueError(f"unknown batch_norm {batch_norm!r}; expected "
                         "'global' or 'per_rank'")
    with timing.span("rnad.learn"):
        params = list(state.net.parameters())
        loss, metrics = learn_loss(state, packed, traj, alpha, cfg,
                                   neurd_scale_for(cfg, state.total_steps),
                                   group=group, batch_norm=batch_norm)
        with timing.span("rnad.learn.backward"):
            grads = torch.autograd.grad(loss, params)
        if group is not None:
            with timing.span("rnad.learn.allreduce"):
                grads = group.sum_tensors(grads)
                if batch_norm == "per_rank":
                    group.average_([b for b in state.net.buffers()
                                    if b.is_floating_point()])
        with timing.span("rnad.learn.update"):
            metrics["gradient_norm"] = g_norm = global_norm(grads, state.net)
            apply_update(cfg, state, grads, g_norm)
        state.total_steps += 1
        return metrics


def make_train_step(tree: GameTree, packed: stepping.PackedTables,
                    cfg: RNaDConfig,
                    obs_transform: Optional[obs_transform_lib.ObsTransform]
                    = None):
    """The fused on-policy step ``train_step(state, alpha, noise=None,
    with_trajectory=False)``: rollout, learn, optimize and EMA; returns
    (state, metrics), and the step's trajectory third under
    ``with_trajectory``.  ``noise`` gives each turn's (g_act, g_chance), and
    the lift's eps under ``obs_transform``; None draws from
    ``state.generator``."""

    def train_step(state: TrainState, alpha: float, noise=None,
                   with_trajectory: bool = False):
        with timing.span("rnad.train_step"):
            traj = rollout(state, tree, packed, cfg, noise, obs_transform)
            metrics = learn_step(state, packed, traj, alpha, cfg)
        return (state, metrics, traj) if with_trajectory else (state, metrics)

    return train_step


def rotate_regularization_nets(state: TrainState) -> TrainState:
    """At each update (m) boundary: pi_reg_prev <- pi_reg; pi_reg <- a copy
    of the target (the target keeps moving in place)."""
    state.net_reg_ = state.net_reg
    state.net_reg = _frozen_copy(state.net_target)
    return state


def alpha_schedule(n: int, delta_m: int) -> float:
    """Linear 0 -> 1 ramp over the first half of each update period."""
    return 1.0 if n > delta_m / 2 else n * 2.0 / delta_m


def nashconv(tree: GameTree, net: nn.Module,
             chunk_nodes: Optional[int] = None,
             obs_transform: Optional[obs_transform_lib.ObsTransform] = None,
             group: Optional[DataGroup] = None
             ) -> nashconv_lib.NashConvResult:
    """Exact best-response values of ``net``'s joint policy: one
    whole-tree pass, or chunked inference of ``chunk_nodes`` nodes a chunk
    where the tree has more (``rnad_tpu``'s ``nashconv_fn``).  Under
    ``obs_transform`` the net sees each node's noise-free lift.  Under
    ``group`` a tree above the chunk threshold goes through the
    node-sharded induction (``metrics/nashconv_shard.py``) after every rank
    has taken the whole joint policy; below it each rank runs the
    whole-tree pass (``rnad_tpu/learn/rnad.py:806-815``)."""
    net = nashconv_lib.lifted(net, obs_transform)
    if chunk_nodes is not None and tree.size > chunk_nodes:
        joint = nashconv_lib.joint_policy_from_net(tree, net, chunk_nodes)
        if group is not None:
            return nashconv_shard.nashconv_sharded(tree, joint, group)
        return nashconv_lib.nashconv_root(tree, joint)
    joint = nashconv_lib.joint_policy_all_nodes(tree, net)
    return nashconv_lib.nashconv_pure(tree, joint, compute_reach=False)


def check_supported(cfg: RNaDConfig, net_config: NetConfig) -> None:
    """Raises ``NotImplementedError`` naming each config field whose value
    the port does not implement, and ``ValueError`` on unknown modes."""
    if cfg.frozen_net_dtype not in nets.DTYPES:
        raise NotImplementedError(
            f"frozen_net_dtype: the port computes in "
            f"{' or '.join(nets.DTYPES)}, got {cfg.frozen_net_dtype!r}")
    if cfg.vtrace_mode not in ("scan", "associative", "auto"):
        raise ValueError(f"unknown vtrace_mode {cfg.vtrace_mode!r}; expected "
                         "'scan', 'associative' or 'auto'")
    if cfg.learner_layout == "amb":
        raise NotImplementedError(
            "learner_layout: the port runs the (T, B, A) layout ('bma', "
            "which 'auto' resolves to off a TPU), not 'amb', whose "
            "batch-minor layout exists for the TPU's 128-lane tile")
    if cfg.learner_layout not in ("bma", "auto"):
        raise ValueError(f"unknown learner_layout {cfg.learner_layout!r}")
    if cfg.rollout_actor_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"rows-actor compute_dtype must be float32 or "
                         f"bfloat16, got {cfg.rollout_actor_dtype}")
    if cfg.reg_anchor not in ("target", "best", "fixed"):
        raise ValueError(f"unknown reg_anchor {cfg.reg_anchor!r}; "
                         "expected 'target', 'best' or 'fixed'")
    check_fuse_mode(cfg.fuse_net_passes)
    if cfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.lr_schedule == "cosine" and cfg.lr_decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs lr_decay_steps > 0")


class RNaD:
    """Host-side experiment loop: fresh-or-resume lifecycle, two-timescale
    schedule, checkpointing, NashConv cadence and best-checkpoint selection
    (``rnad_tpu``'s ``RNaD``).  The run lives in
    ``<runs_root>/<directory_name>`` (``saved_runs/`` under the working
    directory by default, named by the clock if unnamed); a second ``RNaD``
    on the same directory resumes it.  Runs on ``device`` ("cuda" unless
    the caller asks for "cpu").

    TF32 is switched off for matmuls and cuDNN, so every float32 product is
    a float32 product, as on the reference path, and cuDNN runs its
    deterministic algorithms (a ConvNet's resume is bitwise).

    A buffered run keeps its replay buffer and its lane sampler
    (``np.random.default_rng(seed + 1)``) in memory only, as ``rnad_tpu``
    does: neither package checkpoints them, so a resumed buffered run
    starts with an empty buffer and a re-seeded sampler, and is not the
    straight run.

    Under ``group`` (a ``parallel.mesh.DataGroup``) the run is one rank of
    a data-parallel run on ``group.device``: it rolls out its slice of the
    lanes from the global noise stream (``parallel/runtime.py``), and only
    rank 0 touches the shared run directory (``params.json``, checkpoints,
    ``best.ckpt`` and ``metrics.jsonl``), as only process 0 does in
    ``rnad_tpu``; every rank reads it on resume.  A checkpoint holds no
    per-rank state (the weights, Adam and the noise generator are
    replicated), so a run saved by some number of ranks resumes on any
    other that divides the batch.  A ConvNet's BatchNorm normalizes over
    the global batch (``learn_step``'s "global").  The buffered step keeps
    this rank's lanes of each rollout in its buffer, and every rank draws
    the global sampling plan from its own copy of the sampler (seeded
    alike); the lanes a rank's collated positions need from other ranks
    come in one all-reduce per dtype (``TrajectoryBuffer.sample``).

    Under ``group`` a ``parallel.mesh.Grid`` (``runtime.grid``) the run is
    one rank of a (data, model) grid, as under ``rnad_tpu``'s
    ``make_sharded_rnad_fns(model_parallel_mlp=True)``: the data axis as
    above, and the four nets and Adam's moments in the family's
    tensor-parallel layout over the model axis
    (``parallel/tensor_parallel.py``).  The rollout reads the learner's
    whole weights, gathered once a step; NashConv gathers the target's.
    Checkpoints and ``best.ckpt`` hold whole tensors, gathered from the
    shards by every rank, so a run resumes under any layout; only world
    rank 0 writes."""

    def __init__(self, tree: GameTree, cfg: RNaDConfig = RNaDConfig(),
                 net_config: Optional[NetConfig] = None,
                 directory_name: Optional[str] = None,
                 runs_root: Optional[str] = None, seed: int = 0,
                 use_same_init_net_as: Optional[str] = None,
                 use_wandb: bool = False, device="cuda",
                 group: Optional[Union[DataGroup, Grid]] = None):
        if net_config is None:
            net_config = NetConfig(type="MLP", max_actions=tree.max_actions,
                                   width=256)
        check_supported(cfg, net_config)
        grid = group if isinstance(group, Grid) else None
        self._world = group  # the world's rank and barrier
        if grid is not None:
            group = grid.data
        if group is not None:
            from ..parallel import runtime

            runtime.check_data_parallel(cfg, group)
            device = group.device
        if net_config.max_actions != tree.max_actions:
            raise ValueError(f"net max_actions {net_config.max_actions} != "
                             f"tree max_actions {tree.max_actions}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.device = torch.device(device)
        self.tree = tree.to(self.device)
        self.packed = stepping.make_packed_tables(self.tree)
        self.obs_transform = resolve_obs_transform(net_config, self.tree, cfg)
        self.cfg = cfg
        self.net_config = net_config
        self.seed = seed
        if directory_name is None:
            directory_name = str(int(time.time()))
        self.store = RunStore(directory_name, runs_root)
        self.runs_root = runs_root
        self.use_same_init_net_as = use_same_init_net_as
        self.use_wandb = use_wandb
        self.logger: Optional[MetricLogger] = None
        self.group = group
        self.model = None if grid is None else grid.model
        self._writes = group is None or self._world.rank == 0
        if group is None:
            self.train_step = make_train_step(self.tree, self.packed, cfg,
                                              self.obs_transform)
            self._rollout = lambda state: rollout(
                state, self.tree, self.packed, cfg,
                obs_transform=self.obs_transform)
        else:
            self.train_step = runtime.make_sharded_train_step(
                self.tree, self.packed, cfg, self._world, self.obs_transform,
                model_parallel=grid is not None)
            self._rollout = runtime.make_sharded_rollout(
                self.tree, self.packed, cfg, self._world, self.obs_transform,
                model_parallel=grid is not None)
        self.m = 0
        self.n = 0
        self.state: Optional[TrainState] = None
        self.history: List[Tuple[int, Dict[str, float]]] = []
        self._np_rng = np.random.default_rng(seed + 1)

    # -- lifecycle ---------------------------------------------------------

    def _fresh_state(self, init_net: Optional[nn.Module] = None
                     ) -> TrainState:
        """The seed's initial state on the run's device, all four nets a
        copy of ``init_net``'s weights where given."""
        net = nets.build_net(self.net_config,
                             torch.Generator().manual_seed(self.seed),
                             obs_transform_lib.out_channels(
                                 self.cfg.obs_transform))
        if init_net is not None:
            net.load_state_dict(init_net.state_dict())
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed + 1)
        return init_train_state(net.to(self.device), generator)

    def _place(self, state: TrainState) -> TrainState:
        """A whole state, sliced into this rank's shards under a grid."""
        if self.model is None:
            return state
        return tensor_parallel.shard_train_state(state, self.model)

    def _whole(self, state: TrainState) -> TrainState:
        """The state with whole nets and moments, what a checkpoint holds
        (under a grid every rank takes part in the gather)."""
        if self.model is None:
            return state
        return tensor_parallel.gather_train_state(state)

    def initialize(self) -> None:
        """Starts the run fresh (writes ``params.json`` and checkpoint
        (0, 0)) or resumes it from its latest checkpoint; the rollout route
        and the frozen passes raise before the store is touched."""
        if self.state is not None:
            return
        state = self._fresh_state()
        engine.uses_fused_turn(state.net, self.cfg.rollout_rows_actor,
                               self.obs_transform is not None,
                               nets.DTYPES[self.cfg.rollout_actor_dtype])
        resolve_fuse_mode(state.net, self.cfg)
        resumed = False
        fresh = not self.store.exists() or self.store.latest() is None
        if self._world is not None:
            self._world.barrier()  # every rank read the store before rank 0
        if fresh:
            logging.info("initializing R-NaD run %s", self.store.name)
            if self._writes:
                self.store.save_params({
                    "rnad": self.cfg.to_json(),
                    "net": self.net_config.to_json(),
                    "tree_hash": self.tree.hash,
                    "seed": self.seed,
                    "directory_name": self.store.name,
                })
            if self.use_same_init_net_as:
                other = RunStore(self.use_same_init_net_as, self.runs_root)
                loaded = other.load_checkpoint(0, 0, self._fresh_state())
                state = self._fresh_state(loaded.net)
                logging.info("loaded init net from run %s",
                             self.use_same_init_net_as)
            self.state = self._place(state)
            self.m, self.n = 0, 0
            self.save_checkpoint()
        else:
            params = self.store.load_params()
            if int(params["tree_hash"]) != int(self.tree.hash):
                raise AssertionError(
                    "resume tree hash mismatch: run was trained on a "
                    "different tree")
            self.m, self.n = self.store.latest()
            self.state = self._place(
                self.store.load_checkpoint(self.m, self.n, state))
            resumed = True
            logging.info("resumed run %s at m=%d n=%d", self.store.name,
                         self.m, self.n)
        if self.logger is None:
            self.logger = MetricLogger(
                directory=self.store.directory if self._writes else None,
                use_wandb=self.use_wandb and self._writes,
                run_name=self.store.name,
                config={"rnad": self.cfg.to_json(),
                        "net": self.net_config.to_json()},
                resume=resumed)

    def save_checkpoint(self) -> None:
        with timing.span("rnad.checkpoint"):
            state = self._whole(self.state)
            if self._writes:
                self.store.save_checkpoint(self.m, self.n, state)

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        self.history.append((step, metrics))
        self.logger.log(metrics, step)
        logging.info("step %d: %s", step, " ".join(
            f"{k}={v:.6g}" for k, v in sorted(metrics.items())))

    # -- schedule ----------------------------------------------------------

    def _get_update_info(self) -> Tuple[bool, int]:
        """(may_resume, delta_m) from the cumulative m-bounds."""
        bounding = [i for i, b in enumerate(self.cfg.bounds) if b > self.m]
        if not bounding:
            return False, 0
        return True, self.cfg.delta_m[min(bounding)]

    def nashconv(self) -> float:
        """NashConv of the EMA target net.  Above ``nashconv_chunk_nodes``
        nodes, capped by the net's activation footprint
        (``nets.inference_chunk_nodes``), inference runs in chunks.  Under a
        grid it evaluates the target's whole weights."""
        with timing.span("rnad.eval"):
            net = self.state.net_target
            if self.model is not None:
                net = tensor_parallel.gather_module(net)
            chunk = min(self.cfg.nashconv_chunk_nodes,
                        nets.inference_chunk_nodes(net,
                                                   self.tree.max_actions))
            result = nashconv(self.tree, net, chunk, self.obs_transform,
                              self.group)
            for depth, val in nashconv_lib.mean_nashconv_by_depth(
                    self.tree, result).items():
                logging.info("depth:%d nashconv:%f", depth, val)
            return float(result.nashconv())

    # -- main loop ---------------------------------------------------------

    def _seed_best_bar(self) -> None:
        """Resume-safe best-checkpoint bar: a restarted run keeps improving
        on the stored best instead of overwriting it with a worse early
        eval."""
        if hasattr(self, "_best_nashconv"):
            return
        meta = self.store.load_best_meta()
        self._best_nashconv = (float(meta["nashconv"]) if meta
                               else float("inf"))

    def _maybe_save_best(self, value: float, step: int) -> None:
        self._seed_best_bar()
        self._last_nashconv = value
        if value < self._best_nashconv:
            self._best_nashconv = value
            # the target moves in place: keep this eval's weights
            self._best_target = _frozen_copy(self.state.net_target)
            whole = self._whole(self.state)
            if self._writes:
                self.store.save_best(whole, {"nashconv": value,
                                                  "step": step,
                                                  "m": self.m, "n": self.n})
            logging.info("new best nashconv %.6f at step %d", value, step)

    def _rotate_for_schedule(self) -> None:
        """Update-boundary regularization rotation, honoring
        ``cfg.reg_anchor``: "target" is the reference rotation; "best"
        anchors pi_reg to the best checkpoint's target whenever the
        boundary eval came out worse than the best; "fixed" never rotates
        (the reg nets stay the init nets)."""
        if self.cfg.reg_anchor == "fixed":
            return
        if (self.cfg.reg_anchor == "best"
                and getattr(self, "_best_target", None) is not None
                and getattr(self, "_last_nashconv", float("inf"))
                > self._best_nashconv):
            logging.info(
                "reg_anchor=best: eval %.6f worse than best %.6f; "
                "anchoring pi_reg to the best checkpoint's target",
                self._last_nashconv, self._best_nashconv)
            self.state.net_reg_ = self.state.net_reg
            self.state.net_reg = self._best_target
        else:
            rotate_regularization_nets(self.state)

    def final_eval(self) -> float:
        """One exact eval of the current EMA target, logged and folded into
        best-checkpoint selection (the loop evaluates only at update
        boundaries, before training the update)."""
        value = self.nashconv()
        step = self.state.total_steps
        self._log({"nashconv": value}, step)
        self._maybe_save_best(value, step)
        return value

    def buffered_step(self, buffer: buffer_lib.TrajectoryBuffer,
                      alpha: float) -> Dict[str, torch.Tensor]:
        """One buffered learner step: a fresh rollout into ``buffer`` when it
        is empty (a resume at a step count off the ``buffer_mod`` grid) or
        the step count is a multiple of ``buffer_mod``, then ``learn_step``
        on the lanes the buffer samples (``learn_jit.sampled``).  Under a
        group the rollout is this rank's lanes, the sample is the group's
        exchange, and ``total_steps``, replicated, makes every rank take
        the same branch and so issue the same collectives."""
        cfg = self.cfg
        if len(buffer) == 0 or self.state.total_steps % cfg.buffer_mod == 0:
            buffer.append(self._rollout(self.state))
        traj = buffer.sample(cfg.batch_size, self._np_rng, self.group)
        return learn_step(self.state, self.packed, traj, alpha, cfg,
                          self.group, batch_norm="global")

    def run(self, max_updates: int = 10**6, checkpoint_mod: int = 1000,
            expl_mod: int = 1, log_mod: int = 20) -> None:
        """Trains up to ``max_updates`` update periods: a checkpoint before
        each step with ``n % checkpoint_mod == 0``, an eval at each update
        boundary (every ``expl_mod``-th; 0 turns them off) and a metric
        line every ``log_mod`` steps.  A buffered config runs the buffered
        step (module docstring) with a buffer that starts empty."""
        self.initialize()
        cfg = self.cfg
        self._seed_best_bar()
        if (self.cfg.reg_anchor == "best"
                and not hasattr(self, "_best_target")):
            loaded = self.store.load_best(self._fresh_state())
            if loaded is not None:  # resume-safe anchor
                self._best_target = _frozen_copy(
                    self._place(loaded[0]).net_target)
        if self._world is not None:
            self._world.barrier()  # every rank read the store before rank 0
        on_policy = cfg.n_batches_per_buffer == 1 and cfg.buffer_mod == 1
        buffer = buffer_lib.TrajectoryBuffer(cfg.n_batches_per_buffer)
        last_time = time.perf_counter()
        last_steps = self.state.total_steps
        for _ in range(max_updates):
            may_resume, delta_m = self._get_update_info()
            if not may_resume:
                return
            logging.info("m: %d, delta_m: %d", self.m, delta_m)
            buffer.max_size = cfg.n_batches_per_buffer
            if (expl_mod > 0 and self.m % expl_mod == 0 and self.n == 0
                    and self.m != 0):
                value = self.nashconv()
                step = self.state.total_steps
                self._log({"nashconv": value}, step)
                self._maybe_save_best(value, step)
            while self.n < delta_m:
                alpha = alpha_schedule(self.n, delta_m)
                if self.n % checkpoint_mod == 0:
                    self.save_checkpoint()
                if on_policy:
                    _, metrics = self.train_step(self.state, alpha)
                else:
                    metrics = self.buffered_step(buffer, alpha)
                if self.n % log_mod == 0:
                    row = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    steps = self.state.total_steps - last_steps
                    sps = steps / max(now - last_time, 1e-9)
                    row["steps_per_s"] = sps
                    row["env_steps_per_s"] = (sps * cfg.batch_size * 2
                                              * self.tree.max_depth)
                    last_time, last_steps = now, self.state.total_steps
                    self._log(row, self.state.total_steps)
                self.n += 1
            self.n = 0
            self.m += 1
            self._rotate_for_schedule()
