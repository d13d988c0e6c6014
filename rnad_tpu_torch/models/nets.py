"""Policy/value nets: the two-head MLP, the EquiNet and the ConvNet.

Counterpart of ``rnad_tpu/models/nets.py``.  The MLP (the
reference architecture at depth 1) feeds the flattened (2, A, A)
observation to two separate heads, ``policy_fc0 -> relu ->
[policy_hidden{i} -> relu] -> policy_fc1`` (A logits) and the same for the
value (one value), with ``depth - 1`` hidden layers each.  The EquiNet
is a tower of row/column-exchangeable layers over the (A, A) cells, with
optional RM+ solver features (kernel K3 on the card) that can prime its
heads.  The ConvNet is a tower of row + column convolutions (cuDNN) with
masked BatchNorm.  Every net's ``forward(obs, solver_feats=None)`` takes
(N, C, A, A) observations (C = 2 raw, or the lift's channel count) and
returns float32 (logits (N, A), values (N,)); a ConvNet's plain forward
reads its BatchNorm running averages, and ``forward_train`` is the
learner's pass.

``compute_dtype`` follows flax's ``dtype``: the parameters stay float32 (the
optimizer's master copy) and each layer casts its input, kernel and bias to
the compute dtype and computes in it (a bfloat16 product or convolution,
then a bfloat16 bias add, as flax's Dense and Conv do); the outputs leave as
float32.  A ConvNet's BatchNorm computes its statistics and normalizes in
float32 and casts its output to the compute dtype.  The EquiNet's RM+
solver features, and so kernel K3, stay float32.  Every forward takes a
``dtype`` that overrides the net's own for one call: the learner's frozen
passes run a float32 net in bfloat16 that way (``rnad_tpu``'s
``net.clone(dtype=...)``).

Weights cross between the packages through the carrier below: a flax Dense
kernel is (in, out) and a torch Linear weight is (out, in), so the carrier
transposes; the EquiNet's exchangeable kernels keep flax's channels-last
layout and cross as they are; a ConvNet crosses with its BatchNorm
statistics through ``convnet_from_flax``.  Initialization is torch's own
Linear (and Conv2d) default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias, which is the distribution ``rnad_tpu``'s
``torch_linear_kernel_init`` reproduces; draws come from an explicit
generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import NetConfig
from ..env import solver_device

_LAYERS = ("policy_fc0", "policy_fc1", "value_fc0", "value_fc1")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` from float32 parameters."""
    if dtype == torch.float32:
        return layer(x)
    return x.to(dtype) @ layer.weight.to(dtype).t() + layer.bias.to(dtype)


class MLP(nn.Module):
    """Two-headed MLP with ``depth`` hidden layers a head; layer names
    match the flax module's (``{policy,value}_hidden{i}``, i = 1 ..
    depth - 1, between each head's ``fc0`` and ``fc1``)."""

    def __init__(self, max_actions: int, width: int = 256, depth: int = 1,
                 in_channels: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        A = max_actions
        self.max_actions = A
        self.width = width
        self.depth = depth
        self.dtype = dtype
        din = in_channels * A * A
        self.policy_fc0 = nn.Linear(din, width)
        self.policy_fc1 = nn.Linear(width, A)
        self.value_fc0 = nn.Linear(din, width)
        self.value_fc1 = nn.Linear(width, 1)
        hidden = [f"{head}_hidden{i}" for head in ("policy", "value")
                  for i in range(1, depth)]
        for name in hidden:
            setattr(self, name, nn.Linear(width, width))
        with torch.no_grad():
            for name in _LAYERS + tuple(hidden):
                layer = getattr(self, name)
                bound = 1.0 / layer.in_features ** 0.5
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, obs: torch.Tensor, solver_feats=None,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, C, A, A) observations -> (logits (N, A), values (N,)).
        ``solver_feats`` is the EquiNet's; the MLP takes none."""
        del solver_feats
        x = obs.reshape(obs.shape[0], -1)
        return self.head(x, "policy", dtype), self.head(x, "value", dtype)

    def head(self, obs_flat: torch.Tensor, head: str,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One head's forward (``mlp_head_eval``); the tensor-parallel MLP
        (``parallel/tensor_parallel.py``) computes it on its shards."""
        return mlp_head_eval(self, obs_flat, head, dtype)

    def packed_forward(self, x: torch.Tensor, w0: torch.Tensor,
                       b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
        """The two products of ``mlp_multi_net_forward``'s packed pair on
        (N, din) inputs ``x``, each in ``dtype`` followed by its bias add
        in ``dtype``; the tensor-parallel MLP sums the second over the
        model axis."""
        h = torch.relu(x @ w0.to(dtype) + b0.to(dtype))
        return h @ w1.to(dtype) + b1.to(dtype)


# ---------------------------------------------------------------------------
# EquiNet: the permutation-equivariant net with RM+ solver features
# ---------------------------------------------------------------------------

_SolverFeats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def _solver_features(x: torch.Tensor, iters: int) -> _SolverFeats:
    """Six equivariant input channels from an RM+ solve of the observed
    matrix (one K3 launch on the card): the averaged strategies x and y,
    their logs and the action utilities against them, broadcast over the
    other seat's axis, plus the head primers: (feats (N, A, A, 6),
    log x (N, A), value (N,)).  ``x`` is channels-last (N, A, A, 2).
    Gradient-free: pure features of the data."""
    M = x[..., 0].float()  # (N, A, A)
    legal = x[..., 1].float()
    # the legality channel is legal_rows x legal_cols; row and column maxes
    # recover the factors under any relabeling of the actions
    lr = legal.amax(2)
    lc = legal.amax(1)
    xs, ys, v = solver_device.solve_zero_sum_rmplus(M, lr, lc, iters=iters)
    u_r = torch.einsum("nrc,nc->nr", M, ys)  # row utilities against y
    u_c = -torch.einsum("nr,nrc->nc", xs, M)  # col utilities against x
    eps = 1e-9
    log_x = torch.log(xs + eps)
    rows = [xs, log_x, u_r]  # broadcast over columns
    cols = [ys, torch.log(ys + eps), u_c]  # broadcast over rows
    feats = [r[:, :, None].expand(M.shape) for r in rows]
    feats += [c[:, None, :].expand(M.shape) for c in cols]
    return torch.stack(feats, dim=-1), log_x, v


class _ExchangeableDense(nn.Module):
    """One row/column-exchangeable linear layer in block form: the flax
    layer's (6 C_in, C) kernel is cut into six (C_in, C) blocks, each
    contracted against one un-broadcast pool of the channels-last input
    (cell, row mean, column mean, global mean, row max, column max) and the
    results broadcast-added.  The max pools are ``torch.amax``, whose
    gradient splits evenly between tied maxima as JAX's ``reduce_max``
    does (``torch.max(dim=...)`` would give it all to one index)."""

    def __init__(self, in_channels: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / (6 * in_channels) ** 0.5
        self.kernel = nn.Parameter(torch.empty(6 * in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, h: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        cin = h.shape[-1]
        kernel = self.kernel.to(dtype)
        h = h.to(dtype)
        blk = lambda i: kernel[i * cin:(i + 1) * cin]
        out = h @ blk(0)
        out = out + h.mean(dim=2, keepdim=True) @ blk(1)
        out = out + h.mean(dim=1, keepdim=True) @ blk(2)
        out = out + h.mean(dim=(1, 2), keepdim=True) @ blk(3)
        out = out + torch.amax(h, dim=2, keepdim=True) @ blk(4)
        out = out + torch.amax(h, dim=1, keepdim=True) @ blk(5)
        return out + self.bias.to(dtype)


class EquiNet(nn.Module):
    """Permutation-equivariant policy/value net (``rnad_tpu``'s EquiNet).

    The observation goes channels-last (N, A, A, 2), gains the six RM+
    solver channels when ``solver_iters > 0``, and runs through ``depth``
    exchangeable layers with ReLU.  The policy head reads each row's mean
    over columns and the value head the global mean, both concatenated
    with the same pools of the input (the input skip), so relabeling the
    mover's actions permutes the logits and leaves the value unchanged.
    With ``solver_prime`` the heads start at zero and the solve enters
    through unit gates, so the untrained policy is the RM+ solution
    (logits log x) and the value its game value.  Layer names are the flax
    module's: ``ex{i}`` ({kernel (6 C_in, C), bias}), ``policy``, ``value``
    and the gates."""

    def __init__(self, max_actions: int, channels: int = 128,
                 depth: int = 4, solver_iters: int = 0,
                 solver_prime: bool = False, in_channels: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_actions = max_actions
        self.dtype = dtype
        self.channels = channels
        self.depth = depth
        self.solver_iters = solver_iters
        self.primed = bool(solver_iters and solver_prime)
        c0 = in_channels + (6 if solver_iters else 0)
        cin = c0
        for i in range(depth):
            setattr(self, f"ex{i}", _ExchangeableDense(cin, channels,
                                                       generator, dtype))
            cin = channels
        fan = cin + c0
        self.policy = nn.Linear(fan, 1)
        self.value = nn.Linear(fan, 1)
        with torch.no_grad():
            bound = 1.0 / fan ** 0.5
            for head in (self.policy, self.value):
                if self.primed:
                    head.weight.zero_()
                    head.bias.zero_()
                else:
                    head.weight.uniform_(-bound, bound, generator=generator)
                    head.bias.uniform_(-bound, bound, generator=generator)
        if self.primed:
            self.policy_prime_gate = nn.Parameter(torch.ones(()))
            self.value_prime_gate = nn.Parameter(torch.ones(()))

    def forward(self, obs: torch.Tensor,
                solver_feats: Optional[_SolverFeats] = None,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, C, A, A) observations -> (logits (N, A), values (N,)).
        ``solver_feats`` (from ``equinet_solver_features`` on the same
        observations) skips the solve; otherwise it runs here."""
        dtype = dtype or self.dtype
        x = obs.permute(0, 2, 3, 1)  # (N, A, A, C): mover rows, opp cols
        if self.solver_iters:
            feats, log_x, v_rm = (solver_feats if solver_feats is not None
                                  else _solver_features(x, self.solver_iters))
            x = torch.cat([x, feats], dim=-1)
        x = x.to(dtype)
        x0 = x  # input skip to the heads
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"ex{i}")(x, dtype))
        row_feat = torch.cat([x.mean(dim=2), x0.mean(dim=2)], dim=-1)
        glob = torch.cat([x.mean(dim=(1, 2)), x0.mean(dim=(1, 2))], dim=-1)
        logits = _dense(self.policy, row_feat, dtype)[..., 0].float()
        value = _dense(self.value, glob, dtype)[:, 0].float()
        if self.primed:
            logits = logits + self.policy_prime_gate * log_x
            value = value + self.value_prime_gate * v_rm
        return logits, value


# ---------------------------------------------------------------------------
# ConvNet: the CrossConv tower with masked BatchNorm
# ---------------------------------------------------------------------------


def _uniform_(t: torch.Tensor, fan_in: int,
              generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / fan_in ** 0.5
    t.uniform_(-bound, bound, generator=generator)


class CrossConv(nn.Module):
    """Row + column structured convolution over (N, C, A, A): a (1, 2A-1)
    row conv and a (2A-1, 1) column conv, each over A-1 zero padding, summed,
    so every output cell sees its whole row and column.  torch's Conv2d
    initialization (U(+-1/sqrt(fan_in)) for kernel and bias).  In bfloat16
    each convolution rounds to bfloat16 before its bias is added, as flax's
    Conv does."""

    def __init__(self, max_actions: int, in_channels: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        A = max_actions
        self.pad = A - 1
        self.row_conv = nn.Conv2d(in_channels, features, (1, 2 * A - 1))
        self.col_conv = nn.Conv2d(in_channels, features, (2 * A - 1, 1))
        fan_in = in_channels * (2 * A - 1)
        with torch.no_grad():
            for conv in (self.row_conv, self.col_conv):
                _uniform_(conv.weight, fan_in, generator)
                _uniform_(conv.bias, fan_in, generator)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        F = nn.functional
        if dtype == torch.float32:
            r = F.conv2d(x, self.row_conv.weight, self.row_conv.bias,
                         padding=(0, self.pad))
            c = F.conv2d(x, self.col_conv.weight, self.col_conv.bias,
                         padding=(self.pad, 0))
            return r + c
        x = x.to(dtype)
        out = []
        for conv, pad in ((self.row_conv, (0, self.pad)),
                          (self.col_conv, (self.pad, 0))):
            y = F.conv2d(x, conv.weight.to(dtype), padding=pad)
            out.append(y + conv.bias.to(dtype).reshape(1, -1, 1, 1))
        return out[0] + out[1]


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (N, C, H, W) whose batch statistics may leave out
    masked samples (``rnad_tpu``'s ``MaskedBatchNorm``).

    Train mode normalizes by the batch's two-pass population statistics,
    weighted by a per-sample 0/1 ``mask`` over N * H * W cells (no mask:
    every sample) with ``denom = max(sum(mask) * H * W, 1)``, and moves the
    running averages in place with flax's convention ``ra = 0.99 ra + 0.01
    batch`` (outside autograd).  Eval mode normalizes by the running
    averages.  The mode is an argument of each call, never the module's
    ``training`` flag.  The statistics and the normalization are float32;
    the output is cast to ``dtype``.

    Under ``group`` (a ``parallel.mesh.DataGroup``; train mode only) ``x``
    is this rank's slice of the batch and the statistics are those of the
    global batch, as ``rnad_tpu``'s GSPMD path computes them over a sharded
    lane axis: one differentiable all-reduce (``global_sum_grad``) of [the
    per-channel sums of w * x, sum(w)], ``denom`` clamped after that sum
    (so a rank whose own samples are all masked gets the same statistics),
    and one of the per-channel sums of w * (x - mean)^2.  The running
    averages move from the global statistics, so they are equal on every
    rank.  Over one rank the all-reduces change nothing, and the ops are
    the plain path's in its order: a one-rank run is the plain run,
    bitwise.  Not ``torch.nn.SyncBatchNorm``, which has no per-sample mask
    and another variance formula."""

    momentum = 0.99
    epsilon = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                group=None) -> torch.Tensor:
        view = lambda v: v.reshape(1, -1, 1, 1)
        x = x.float()
        if not train:
            mean, var = self.mean, self.var
        else:
            axes = (0, 2, 3)
            total = (group.global_sum_grad if group is not None
                     else lambda t: t)
            w = (torch.ones(x.shape[0], device=x.device) if mask is None
                 else mask.float()).reshape(-1, 1, 1, 1)
            per_sample = float(x.shape[2] * x.shape[3])
            sums = total(torch.cat([(x * w).sum(dim=axes),
                                    w.sum().reshape(1)]))
            denom = torch.clamp(sums[-1] * per_sample, min=1.0)
            mean = sums[:-1] / denom
            var = total((((x - view(mean)) ** 2) * w).sum(dim=axes)) / denom
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        y = (x - view(mean)) * torch.rsqrt(view(var) + self.epsilon)
        return (y * view(self.scale) + view(self.bias)).to(dtype)


class ConvResBlock(nn.Module):
    """x + [CrossConv, ReLU, BN] twice (the BN only with ``batch_norm``)."""

    def __init__(self, max_actions: int, channels: int,
                 batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.batch_norm = batch_norm
        self.conv0 = CrossConv(max_actions, channels, channels, generator)
        self.conv1 = CrossConv(max_actions, channels, channels, generator)
        if batch_norm:
            self.bn0 = MaskedBatchNorm(channels)
            self.bn1 = MaskedBatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                group=None) -> torch.Tensor:
        h = x
        for i in range(2):
            h = torch.relu(getattr(self, f"conv{i}")(h, dtype))
            if self.batch_norm:
                h = getattr(self, f"bn{i}")(h, train, mask, dtype, group)
        return x + h


class ConvNet(nn.Module):
    """AlphaZero-style tower (``rnad_tpu``'s ConvNet): a ``pre`` CrossConv
    to ``channels``, ``depth`` residual blocks, and linear ``policy`` (A
    logits) and ``value`` heads over the (A, A, C) flattening in flax's
    channels-last order, in float32 or bfloat16.

    ``forward(obs, solver_feats=None, train=False, mask=None, group=None)``:
    train mode normalizes by the batch's statistics (leaving out samples
    whose ``mask`` is 0; over the global batch under a data-parallel
    ``group``) and moves the BatchNorm running averages; eval mode, the
    default, reads them."""

    def __init__(self, max_actions: int, channels: int = 16, depth: int = 1,
                 batch_norm: bool = True, in_channels: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        A = max_actions
        self.max_actions = A
        self.channels = channels
        self.depth = depth
        self.dtype = dtype
        self.pre = CrossConv(A, in_channels, channels, generator)
        for i in range(depth):
            setattr(self, f"block{i}", ConvResBlock(A, channels, batch_norm,
                                                    generator))
        fan = channels * A * A
        self.policy = nn.Linear(fan, A)
        self.value = nn.Linear(fan, 1)
        with torch.no_grad():
            for head in (self.policy, self.value):
                _uniform_(head.weight, fan, generator)
                _uniform_(head.bias, fan, generator)

    def forward(self, obs: torch.Tensor, solver_feats=None,
                train: bool = False, mask: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, C, A, A) observations -> (logits (N, A), values (N,))."""
        del solver_feats
        dtype = dtype or self.dtype
        if mask is not None:
            mask = mask.reshape(-1)
        x = self.pre(obs.to(dtype), dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, train, mask, dtype, group)
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC
        return (_dense(self.policy, flat, dtype).float(),
                _dense(self.value, flat, dtype)[:, 0].float())


def forward_train(net: nn.Module, obs: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  solver_feats=None, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The learner's pass (``rnad_tpu``'s ``apply_train``): a ConvNet in
    train mode with the per-sample ``mask`` (its BatchNorm running averages
    move), its statistics over the global batch under ``group``; any other
    net as its plain forward."""
    if isinstance(net, ConvNet):
        return net(obs, train=True, mask=mask, group=group)
    return net(obs, solver_feats)


def equinet_solver_features(net: EquiNet, obs_flat: torch.Tensor
                            ) -> _SolverFeats:
    """The solver features of ``net`` (solver_iters > 0) for the
    observations ``obs_flat`` (N, 2, A, A), computed once for several
    forwards over them (the learner's four passes)."""
    A = net.max_actions
    x = obs_flat.reshape(-1, 2, A, A).permute(0, 2, 3, 1)
    return _solver_features(x, net.solver_iters)


def build_net(config: NetConfig,
              generator: Optional[torch.Generator] = None,
              in_channels: int = 2) -> nn.Module:
    """The net of ``config`` for observations of ``in_channels`` channels
    (2 raw, or ``obs_transform.out_channels`` under a lift)."""
    dtype = DTYPES.get(config.compute_dtype)
    if dtype is None:
        raise NotImplementedError(
            f"NetConfig.compute_dtype: the port computes in "
            f"{' or '.join(DTYPES)}, got {config.compute_dtype!r}")
    if config.type == "EquiNet":
        return EquiNet(config.max_actions, channels=config.channels,
                       depth=config.depth, solver_iters=config.solver_iters,
                       solver_prime=config.solver_prime,
                       in_channels=in_channels, generator=generator,
                       dtype=dtype)
    if config.type == "ConvNet":
        return ConvNet(config.max_actions, channels=config.channels,
                       depth=config.depth, batch_norm=config.batch_norm,
                       in_channels=in_channels, generator=generator,
                       dtype=dtype)
    if config.type != "MLP":
        raise ValueError(f"unknown net type: {config.type}")
    return MLP(config.max_actions, config.width, config.depth,
               in_channels=in_channels, generator=generator, dtype=dtype)


def inference_chunk_nodes(net: nn.Module, max_actions: int,
                          budget_bytes: int = 2 << 30,
                          cap: int = 200_000) -> int:
    """Largest whole-tree inference chunk (in nodes) whose peak activations
    fit ``budget_bytes``: the dominant per-row terms of the family's
    forward in the net's compute dtype, times two seats per node and 2x
    slack, clamped to [1024, cap] (``rnad_tpu``'s formula and budget)."""
    A = max_actions
    esz = net.dtype.itemsize
    if isinstance(net, EquiNet):
        cin = 2 + (6 if net.solver_iters else 0)
        width = max(6 * net.channels, 6 * cin)
        per_row = A * A * (width * esz + net.channels * 4)
    elif isinstance(net, ConvNet):
        per_row = A * A * (2 * A - 1) * net.channels * esz  # im2col rows
    else:  # the MLP
        per_row = (2 * A * A + 2 * net.width) * esz
    per_node = 2 * per_row * 2
    return max(1024, min(cap, int(budget_bytes // per_node)))


def params_from_flax(np_params: Dict[str, Dict[str, np.ndarray]]
                     ) -> Dict[str, torch.Tensor]:
    """flax ``params`` -> a state_dict for :class:`MLP` (any depth: its
    ``*_hidden{i}`` layers are Dense layers like the others) or
    :class:`EquiNet`.  Dense layers ({kernel (in, out), bias}) become torch
    Linears (weight (out, in)); the EquiNet's ``ex{i}`` kernels keep the
    flax layout and its gates are scalars."""
    state = {}
    for name, layer in np_params.items():
        if name.endswith("_gate"):
            state[name] = torch.as_tensor(np.array(layer))
        elif name.startswith("ex"):
            state[f"{name}.kernel"] = torch.as_tensor(np.array(layer["kernel"]))
            state[f"{name}.bias"] = torch.as_tensor(np.array(layer["bias"]))
        else:
            state[f"{name}.weight"] = torch.as_tensor(
                np.array(layer["kernel"]).T.copy())
            state[f"{name}.bias"] = torch.as_tensor(np.array(layer["bias"]))
    return state


def params_to_flax(module: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """:class:`MLP` (any depth) or :class:`EquiNet` -> flax-layout
    ``params`` of numpy arrays."""
    out: Dict = {}
    for key, p in module.state_dict().items():
        a = p.detach().cpu().numpy().copy()
        if "." not in key:  # an EquiNet gate
            out[key] = a
            continue
        name, leaf = key.split(".")
        if leaf == "weight":
            out.setdefault(name, {})["kernel"] = a.T.copy()
        else:
            out.setdefault(name, {})[leaf] = a
    return out


def convnet_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A flax ConvNet's ``{"params": ..., "batch_stats": ...}`` -> a
    state_dict for :class:`ConvNet`.  Conv kernels go from flax's HWIO to
    torch's OIHW; Dense kernels (in, out) are transposed (the flattening
    is flax's NHWC order on both sides); BatchNorm ``scale``/``bias`` and
    the ``mean``/``var`` statistics keep their names."""
    state = {}

    def walk(tree, prefix):
        for name, leaf in tree.items():
            key = f"{prefix}{name}"
            if isinstance(leaf, dict):
                walk(leaf, key + ".")
                continue
            a = np.array(leaf)
            if name == "kernel" and a.ndim == 4:
                state[f"{prefix}weight"] = torch.as_tensor(
                    a.transpose(3, 2, 0, 1).copy())
            elif name == "kernel":
                state[f"{prefix}weight"] = torch.as_tensor(a.T.copy())
            else:
                state[key] = torch.as_tensor(a)

    walk(variables["params"], "")
    walk(variables.get("batch_stats", {}), "")
    return state


def convnet_to_flax(module: "ConvNet") -> Dict:
    """:class:`ConvNet` -> flax-layout ``{"params", "batch_stats"}`` of
    numpy arrays (the inverse of :func:`convnet_from_flax`)."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().numpy().copy()
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        if leaf == "weight":
            leaf = "kernel"
            a = a.transpose(2, 3, 1, 0).copy() if a.ndim == 4 else a.T.copy()
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def mlp_fused_weights(net: MLP) -> Tuple[torch.Tensor, ...]:
    """Both heads as one fused pair: W0 = [policy_fc0 | value_fc0]
    (din, 2W), b0 (2W,); W1 (2W, A+1) block-diagonal, mapping the policy
    half to the A logits and the value half to column A; b1 (A+1,).
    Depth-1 MLPs only: the packing has no place for hidden layers, so a
    deeper MLP raises rather than losing them.  A tensor-parallel MLP's
    pair is its shards' (W its part of the width)."""
    if net.depth != 1:
        raise ValueError(f"mlp_fused_weights supports depth=1 MLPs only "
                         f"(got depth={net.depth})")
    A, W = net.max_actions, net.policy_fc0.weight.shape[0]
    w0 = torch.cat([net.policy_fc0.weight.t(), net.value_fc0.weight.t()], 1)
    b0 = torch.cat([net.policy_fc0.bias, net.value_fc0.bias])
    w1 = torch.zeros((2 * W, A + 1), dtype=w0.dtype, device=w0.device)
    w1[:W, :A] = net.policy_fc1.weight.t()
    w1[W:, A] = net.value_fc1.weight[0]
    b1 = torch.cat([net.policy_fc1.bias, net.value_fc1.bias])
    return w0.contiguous(), b0, w1, b1


def mlp_head_eval(net: MLP, obs_flat: torch.Tensor, head: str,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One head's forward: ``logits (N, A)`` for ``head="policy"`` or
    ``values (N,)`` for ``head="value"``.  The heads share nothing, so a
    consumer of one head skips the other's matmuls (the learner's frozen
    passes need only the target's value and the reg nets' policies).
    Computed in ``dtype`` (default: the net's) through ``fc0``, the hidden
    layers and ``fc1``; float32 out."""
    dtype = dtype or net.dtype
    h = obs_flat.reshape(obs_flat.shape[0], -1).to(dtype)
    layers = [f"{head}_fc0"]
    layers += [f"{head}_hidden{i}" for i in range(1, net.depth)]
    for name in layers:
        h = torch.relu(_dense(getattr(net, name), h, dtype))
    out = _dense(getattr(net, f"{head}_fc1"), h, dtype).float()
    return out[:, 0] if head == "value" else out


def mlp_multi_net_forward(nets: Sequence[MLP], obs_flat: torch.Tensor,
                          dtype: torch.dtype
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n depth-1 MLPs' forwards over the same observations as one matmul
    pair (``rnad_tpu``'s ``mlp_multi_net_forward``): each net's fused pair
    (``mlp_fused_weights``), the W0s concatenated along the hidden axis
    into (din, n 2W) and the W1s placed block-diagonally into (n 2W, n (A +
    1)), computed in ``dtype``.  Gradients reach only the nets whose
    weights require them.  Returns float32 (logits (N, n, A), values (N,
    n))."""
    A = nets[0].max_actions
    fused = [mlp_fused_weights(net) for net in nets]
    w0 = torch.cat([f[0] for f in fused], 1)
    b0 = torch.cat([f[1] for f in fused])
    w1 = torch.block_diag(*[f[2] for f in fused])
    b1 = torch.cat([f[3] for f in fused])
    x = obs_flat.reshape(obs_flat.shape[0], -1).to(dtype)
    out = nets[0].packed_forward(x, w0, b0, w1, b1, dtype).float()
    out = out.reshape(-1, len(nets), A + 1)
    return out[..., :A], out[..., A]
