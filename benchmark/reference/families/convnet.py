"""The plain ConvNet (``rnad_tpu/models/nets.py``'s ConvNet): a ``pre``
CrossConv to ``channels``, ``depth`` residual blocks x + [CrossConv, ReLU,
BatchNorm] x 2, and linear policy (A logits) and value heads over the
channels-last (A, A, C) flattening.

A CrossConv sums a row convolution (kernel (1, 2A - 1)) and a column
convolution ((2A - 1, 1)), each over A - 1 zero padding, so that an output
cell sees its whole row and column.  Here each is one product: an output
row's A cells of C_in channels, gathered, against the kernel's taps
gathered into an (A C_in, A C_out) matrix, whose entry for input column
j' and output column j is the tap j' - j + A - 1.  So the products run in
``Precision`` (the control rounds them as a TF32 convolution would) and
count only the needed multiply-adds (``work/convnet.py``): the zero
padding's products, which add exact zeros, are left out.  In bfloat16 each
of the two products rounds to bfloat16 before its bias is added, as
flax's Conv does.

The masked BatchNorm (``rnad_tpu``'s ``MaskedBatchNorm``), per channel over
the N x A x A cells: train mode normalizes by the batch's two-pass
population statistics over the samples whose ``mask`` is 1, with
``denom = max(sum(mask) * A^2, 1)``, and moves the running averages,
outside autograd, as flax does: ``ra = 0.99 ra + 0.01 batch``; eval mode
normalizes by the running averages.  The statistics and the normalization
are float32, eps 1e-5, and the output is cast to the compute type.

Departures from the description, none of them in the arithmetic's
meaning: the kernels are held in torch's layout under the program's
state_dict names (a convolution's weight (C_out, C_in, kh, kw), a Linear's
(out, in)), the activations are channels-last, and the convolutions sum
their taps in the gathered product's order, not cuDNN's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nets import Params, Precision

MOMENTUM = 0.99
EPSILON = 1e-5


def _gathered(weight: torch.Tensor, A: int) -> torch.Tensor:
    """A convolution's (C_out, C_in, 2A - 1) taps as the (A C_in, A C_out)
    matrix of an output row: row (j', c) and column (j, o) hold tap
    j' - j + A - 1 of (o, c)."""
    O, C, _ = weight.shape
    j = torch.arange(A, device=weight.device)
    w = weight[:, :, j[:, None] - j[None, :] + A - 1]  # (O, C, j', j)
    return w.permute(2, 1, 3, 0).reshape(A * C, A * O)


def _line_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               prec: Precision) -> torch.Tensor:
    """A convolution along the last spatial axis of channels-last ``x``
    (N, A, A, C_in) -> (N, A, A, C_out)."""
    N, A, _, C = x.shape
    out = prec.mm(x.reshape(N * A, A * C), _gathered(weight, A))
    return out.reshape(N, A, A, -1) + bias.to(prec.dtype)


def cross_conv(params: Params, name: str, x: torch.Tensor,
               prec: Precision) -> torch.Tensor:
    """The CrossConv ``name`` over channels-last ``x``: the row
    convolution along each row plus the column convolution along each
    column."""
    rows = _line_conv(x, params[f"{name}.row_conv.weight"][:, :, 0, :],
                      params[f"{name}.row_conv.bias"], prec)
    cols = _line_conv(x.transpose(1, 2),
                      params[f"{name}.col_conv.weight"][:, :, :, 0],
                      params[f"{name}.col_conv.bias"], prec).transpose(1, 2)
    return rows + cols


def batch_norm(params: Params, state: Params, name: str, x: torch.Tensor,
               train: bool, mask: Optional[torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
    """The masked BatchNorm ``name`` over channels-last ``x`` (module
    docstring); in train mode it moves ``state``'s running averages."""
    x = x.float()
    if train:
        A2 = x.shape[1] * x.shape[2]
        w = (torch.ones(x.shape[0], device=x.device) if mask is None
             else mask.float()).reshape(-1, 1, 1, 1)
        denom = torch.clamp(w.sum() * A2, min=1.0)
        mean = (x * w).sum((0, 1, 2)) / denom
        var = (((x - mean) ** 2) * w).sum((0, 1, 2)) / denom
        with torch.no_grad():
            for key, batch in (("mean", mean), ("var", var)):
                ra = state[f"{name}.{key}"]
                state[f"{name}.{key}"] = (MOMENTUM * ra
                                          + (1.0 - MOMENTUM) * batch)
    else:
        mean, var = state[f"{name}.mean"], state[f"{name}.var"]
    y = (x - mean) * torch.rsqrt(var + EPSILON)
    return (y * params[f"{name}.scale"] + params[f"{name}.bias"]).to(dtype)


def forward(params: Params, obs: torch.Tensor, net: dict, prec: Precision,
            feats=None, state: Optional[Params] = None, train: bool = False,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, A, A) observations -> (logits (N, A), values (N,)).  With
    BatchNorm, ``state`` holds the running averages: read in eval mode,
    moved in train mode, where ``mask`` (N,) weighs the statistics."""
    del feats
    x = obs.permute(0, 2, 3, 1).to(prec.dtype)
    x = cross_conv(params, "pre", x, prec)
    for i in range(net["depth"]):
        h = x
        for j in range(2):
            h = torch.relu(cross_conv(params, f"block{i}.conv{j}", h, prec))
            if net.get("batch_norm", True):
                h = batch_norm(params, state, f"block{i}.bn{j}", h, train,
                               mask, prec.dtype)
        x = x + h
    flat = x.reshape(x.shape[0], -1)
    return (prec.dense(flat, params["policy.weight"],
                       params["policy.bias"]).float(),
            prec.dense(flat, params["value.weight"],
                       params["value.bias"])[:, 0].float())


def features(net: dict, obs: torch.Tensor, solver=None) -> None:
    """The ConvNet shares nothing between its passes."""
    return None


def _cross_conv_shapes(name: str, cin: int, cout: int, A: int):
    bound = (cin * (2 * A - 1)) ** -0.5
    out = []
    for conv, kernel in (("row_conv", (1, 2 * A - 1)),
                         ("col_conv", (2 * A - 1, 1))):
        out += [(f"{name}.{conv}.weight", (cout, cin) + kernel, bound),
                (f"{name}.{conv}.bias", (cout,), bound)]
    return out


def param_shapes(net: dict, A: int, in_channels: int = 2):
    """The trained leaves at A actions and ``in_channels`` input channels
    in the program's state_dict order: (name, shape, bound), each starting
    U(-bound, bound) at torch's Conv2d and Linear defaults (fan-in
    C_in (2A - 1) for a CrossConv, C A^2 for a head); a BatchNorm's scale
    starts at 1 (bound None) and its bias at 0 (bound 0), as the program's
    do."""
    C = net["channels"]
    out = _cross_conv_shapes("pre", in_channels, C, A)
    for i in range(net["depth"]):
        for j in range(2):
            out += _cross_conv_shapes(f"block{i}.conv{j}", C, C, A)
        if net.get("batch_norm", True):
            for j in range(2):
                out += [(f"block{i}.bn{j}.scale", (C,), None),
                        (f"block{i}.bn{j}.bias", (C,), 0.0)]
    fan = C * A * A
    for head, width in (("policy", A), ("value", 1)):
        out += [(f"{head}.weight", (width, fan), fan ** -0.5),
                (f"{head}.bias", (width,), fan ** -0.5)]
    return out


def state_shapes(net: dict, A: int, in_channels: int = 2):
    """The BatchNorm running averages in the program's state_dict order:
    (name, shape, (low, high)); drawn away from the program's 0 and 1, so
    that a pass that reads the batch where it should read them, or the
    reverse, parts from the reference at the first step."""
    if not net.get("batch_norm", True):
        return []
    C = net["channels"]
    return [(f"block{i}.bn{j}.{key}", (C,), span)
            for i in range(net["depth"]) for j in range(2)
            for key, span in (("mean", (-0.5, 0.5)), ("var", (0.5, 1.5)))]
