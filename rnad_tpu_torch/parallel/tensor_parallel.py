"""The model axis: the tensor-parallel layouts of the three net families and
the four operators that carry their collectives.

Counterpart of ``rnad_tpu/parallel/mesh.py:89-164`` (``mlp_param_spec``,
``conv_param_spec``, ``equinet_param_spec``, ``shard_variables``) and of the
collectives GSPMD inserts for those layouts.  Under GSPMD a spec is a
layout hint that changes no value; here each collective and its backward
is code, and a rank holds only its shards of the sharded tensors (the
``ModelGroup``'s part of a dimension: ``torch.tensor_split``'s, so an
uneven split is allowed, as GSPMD pads it).

The layouts, in torch's tensor layouts (a ``Linear.weight`` is flax's
Dense kernel transposed, a conv weight is OIHW where flax's is HWIO):

* MLP (``mlp_param_spec``): ``fc0`` is column-parallel (weight dim 0 and
  bias), ``fc1`` row-parallel (weight dim 1; bias replicated); the hidden
  layers alternate, Megatron-style: odd ones row-parallel, even ones
  column-parallel.  With an even ``depth`` the last hidden layer is
  row-parallel and its whole output feeds the row-parallel ``fc1``: a
  scatter takes this rank's columns there (GSPMD slices silently).
* ConvNet (``conv_param_spec``): every convolution's output channels
  (weight dim 0 and bias) and every BatchNorm vector (scale, bias and the
  running ``mean`` and ``var``); the dense heads replicated.
* EquiNet (``equinet_param_spec``): each ``ex{i}`` kernel's output
  channels (its (6 C_in, C) kernel keeps flax's layout: dim 1) and bias;
  the heads and gates replicated.

The operators, m the model axis's size, each a ``torch.autograd.Function``
whose collective is one ``all_reduce`` (gloo has no ``all_gather`` for
CUDA tensors, ``mesh.py``):

* ``copy_to_model``: identity forward, all-reduce backward; on the whole
  input of every column-parallel layer (the layer's m partial input
  gradients add up to the input's).
* ``reduce_from_model``: all-reduce forward, identity backward; on the
  output of every row-parallel layer (the replicated bias is added once,
  after the sum).
* ``gather_from_model``: the shards concatenated (a zero-filled
  all-reduce: each rank writes its part, the rest adds exact zeros), this
  rank's part of the gradient sliced out in the backward.
* ``scatter_to_model``: this rank's part sliced out, the gradient gathered
  in the backward; where a whole activation feeds a row-parallel layer.

Every model rank computes the same loss from the same whole outputs, so
autograd gives each rank the whole gradient of each replicated parameter
and its own part of each sharded one; ``learn.rnad.learn_step`` sums them
over the data axis only.  On one model rank every operator returns its
input and each layer runs the plain net's operations, so a 1 x 1 grid is
the plain run bitwise.

The nets here are the families' subclasses (``isinstance`` against
``models.nets`` holds) that hold their shards, their ``ModelGroup`` and
the whole sizes of the sharded tensors; ``shard_module`` makes one from a
whole net and ``gather_module`` the whole plain net back.  Checkpoints,
NashConv and the rollout's actor read whole nets.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models import nets
from ..utils.checkpoint import NETS
from .mesh import ModelGroup


# ---------------------------------------------------------------------------
# the four operators
# ---------------------------------------------------------------------------


def gather_tensors(parts: Sequence[Tuple[torch.Tensor, int, int]],
                   model: ModelGroup) -> List[torch.Tensor]:
    """The whole tensors of ``parts``, each (this rank's shard, its
    dimension, the dimension's whole size): one zero-filled all-reduce of
    them all (one dtype)."""
    whole = []
    for t, dim, size in parts:
        shape = list(t.shape)
        shape[dim] = size
        buf = t.new_zeros(shape)
        buf.narrow(dim, *model.part(size)).copy_(t)
        whole.append(buf)
    return model.sum_tensors(whole)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.model.global_sum(grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        return model.global_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, size, model):
        ctx.dim, ctx.part = dim, model.part(size)
        return gather_tensors([(x, dim, size)], model)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, *ctx.part).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, model):
        ctx.dim, ctx.size, ctx.model = dim, x.shape[dim], model
        return x.narrow(dim, *model.part(x.shape[dim])).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_tensors([(grad, ctx.dim, ctx.size)],
                              ctx.model)[0], None, None


# On one rank each operator is ``x`` itself: no autograd node, so the net's
# graph, and the order in which autograd adds a tensor's gradients, is the
# plain net's.


def copy_to_model(x: torch.Tensor, model: ModelGroup) -> torch.Tensor:
    """``x`` (whole on every model rank); its gradient summed over them."""
    return x if model.world == 1 else _CopyToModel.apply(x, model)


def reduce_from_model(x: torch.Tensor, model: ModelGroup) -> torch.Tensor:
    """The sum of the ranks' partial ``x``; the gradient passes as it is."""
    return x if model.world == 1 else _ReduceFromModel.apply(x, model)


def gather_from_model(x: torch.Tensor, dim: int, size: int,
                      model: ModelGroup) -> torch.Tensor:
    """The whole tensor of the ranks' shards ``x`` of dimension ``dim``
    (whole size ``size``); this rank's part of the gradient."""
    return x if model.world == 1 else _Gather.apply(x, dim, size, model)


def scatter_to_model(x: torch.Tensor, dim: int,
                     model: ModelGroup) -> torch.Tensor:
    """This rank's part of the whole ``x`` along ``dim``; the gradient
    gathered from the ranks' parts."""
    return x if model.world == 1 else _Scatter.apply(x, dim, model)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------


def mlp_shard_dim(name: str) -> Optional[int]:
    """``mlp_param_spec`` for a torch MLP's state-dict ``name``: 0 for a
    column-parallel layer's weight and bias, 1 for a row-parallel layer's
    weight, None (replicated) for its bias and anything else."""
    layer, leaf = name.rsplit(".", 1)
    m = re.search(r"_(fc0|fc1|hidden(\d+))$", layer)
    if m is None:
        return None
    row = m.group(1) == "fc1" or (m.group(2) is not None
                                  and int(m.group(2)) % 2 == 1)
    if not row:
        return 0
    return 1 if leaf == "weight" else None


def conv_shard_dim(name: str, t: torch.Tensor) -> Optional[int]:
    """``conv_param_spec``: 0 (output channels) for a conv weight and for
    every per-channel vector of a convolution or a BatchNorm; None for the
    dense heads."""
    if t.ndim == 4 or (t.ndim == 1 and ("conv" in name or "bn" in name)):
        return 0
    return None


def equinet_shard_dim(name: str) -> Optional[int]:
    """``equinet_param_spec``: 1 for an ``ex{i}`` kernel (6 C_in, C), 0 for
    its bias; None for the heads and gates."""
    if re.fullmatch(r"ex\d+\.kernel", name):
        return 1
    if re.fullmatch(r"ex\d+\.bias", name):
        return 0
    return None


def shard_dim(net: nn.Module, name: str, t: torch.Tensor) -> Optional[int]:
    """The dimension the family's layout shards the tensor ``name`` of
    ``net`` on, or None where it is replicated."""
    if isinstance(net, nets.ConvNet):
        return conv_shard_dim(name, t)
    if isinstance(net, nets.EquiNet):
        return equinet_shard_dim(name)
    if isinstance(net, nets.MLP):
        return mlp_shard_dim(name)
    raise TypeError(f"no tensor-parallel layout for {type(net).__name__}")


def _tensors(net: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """The net's parameters and buffers, by state-dict name."""
    return itertools.chain(net.named_parameters(), net.named_buffers())


# ---------------------------------------------------------------------------
# the tensor-parallel nets
# ---------------------------------------------------------------------------


class TensorParallel:
    """A net holding this rank's shards: its ``model`` group and, for each
    sharded tensor, ``whole[name] = (dim, whole size)``."""

    model: ModelGroup
    whole: Dict[str, Tuple[int, int]]


def _row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                  model: ModelGroup) -> torch.Tensor:
    """A row-parallel dense layer: this rank's input columns to the whole
    output, the replicated bias added once after the sum.  On one rank the
    plain layer (the sum is the identity)."""
    if model.world == 1:
        return nets._dense(layer, x, dtype)
    y = x.to(dtype) @ layer.weight.to(dtype).t()
    return reduce_from_model(y, model) + layer.bias.to(dtype)


class MLP(TensorParallel, nets.MLP):
    """The MLP in ``mlp_param_spec``'s layout (module docstring)."""

    def head(self, obs_flat: torch.Tensor, head: str,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        h = obs_flat.reshape(obs_flat.shape[0], -1).to(dtype)
        names = ([f"{head}_fc0"]
                 + [f"{head}_hidden{i}" for i in range(1, self.depth)]
                 + [f"{head}_fc1"])
        whole = True  # h is the whole activation on every model rank
        for k, name in enumerate(names):
            layer = getattr(self, name)
            column = mlp_shard_dim(f"{name}.weight") == 0
            if column:
                h = nets._dense(layer, copy_to_model(h, self.model), dtype)
            else:
                if whole:  # even depth: this rank's columns
                    h = scatter_to_model(h, 1, self.model)
                h = _row_parallel(layer, h, dtype, self.model)
            whole = not column
            if k < len(names) - 1:
                h = torch.relu(h)
        out = h.float()
        return out[:, 0] if head == "value" else out

    def packed_forward(self, x, w0, b0, w1, b1, dtype):
        """``mlp_multi_net_forward``'s pair on this rank's shards: the
        packed fc0 columns and fc1 rows, then one sum of the packed output
        over the model axis before the replicated fc1 biases."""
        if self.model.world == 1:
            return super().packed_forward(x, w0, b0, w1, b1, dtype)
        h = torch.relu(copy_to_model(x, self.model) @ w0.to(dtype)
                       + b0.to(dtype))
        return reduce_from_model(h @ w1.to(dtype), self.model) + b1.to(dtype)


class ConvNet(TensorParallel, nets.ConvNet):
    """The ConvNet in ``conv_param_spec``'s layout: each CrossConv reads
    the whole input through ``copy_to_model`` and computes this rank's
    channels, ReLU and BatchNorm (its statistics over the data axis's
    ``group``) act on them, and a gather follows each conv step, before
    the residual add or the next convolution; the last one feeds the
    replicated heads (1 + 2 depth gathers a forward)."""

    def forward(self, obs, solver_feats=None, train=False, mask=None,
                dtype=None, group=None):
        del solver_feats
        dtype = dtype or self.dtype
        if mask is not None:
            mask = mask.reshape(-1)
        C, model = self.channels, self.model
        x = gather_from_model(self.pre(copy_to_model(obs.to(dtype), model),
                                       dtype), 1, C, model)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            h = x
            for j in range(2):
                h = torch.relu(getattr(block, f"conv{j}")(
                    copy_to_model(h, model), dtype))
                if block.batch_norm:
                    h = getattr(block, f"bn{j}")(h, train, mask, dtype, group)
                h = gather_from_model(h, 1, C, model)
            x = x + h
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return (nets._dense(self.policy, flat, dtype).float(),
                nets._dense(self.value, flat, dtype)[:, 0].float())


class EquiNet(TensorParallel, nets.EquiNet):
    """The EquiNet in ``equinet_param_spec``'s layout: each exchangeable
    layer reads the whole input through ``copy_to_model`` and computes this
    rank's output channels (its pools reduce spatial axes only), and one
    gather a layer feeds the next layer's six blocks or, after the last,
    the heads.  The solver features (K3) and the input skip are computed
    whole on every model rank."""

    def forward(self, obs, solver_feats=None, dtype=None):
        dtype = dtype or self.dtype
        x = obs.permute(0, 2, 3, 1)
        if self.solver_iters:
            feats, log_x, v_rm = (solver_feats if solver_feats is not None
                                  else nets._solver_features(
                                      x, self.solver_iters))
            x = torch.cat([x, feats], dim=-1)
        x = x.to(dtype)
        x0 = x
        for i in range(self.depth):
            h = getattr(self, f"ex{i}")(copy_to_model(x, self.model), dtype)
            x = gather_from_model(torch.relu(h), 3, self.channels,
                                  self.model)
        row_feat = torch.cat([x.mean(dim=2), x0.mean(dim=2)], dim=-1)
        glob = torch.cat([x.mean(dim=(1, 2)), x0.mean(dim=(1, 2))], dim=-1)
        logits = nets._dense(self.policy, row_feat, dtype)[..., 0].float()
        value = nets._dense(self.value, glob, dtype)[:, 0].float()
        if self.primed:
            logits = logits + self.policy_prime_gate * log_x
            value = value + self.value_prime_gate * v_rm
        return logits, value


_PARALLEL = {nets.MLP: MLP, nets.ConvNet: ConvNet, nets.EquiNet: EquiNet}
_PLAIN = {v: k for k, v in _PARALLEL.items()}


@torch.no_grad()
def shard_module(net: nn.Module, model: ModelGroup) -> nn.Module:
    """Slices the whole plain ``net`` into this rank's shards, in place,
    and returns it as its family's tensor-parallel net.  Every rank of a
    model row slices the same whole net (built from one generator), so
    they start from one rank's weights."""
    whole = {}
    for name, t in _tensors(net):
        dim = shard_dim(net, name, t)
        if dim is not None:
            whole[name] = (dim, t.shape[dim])
            t.data = t.data.narrow(dim, *model.part(t.shape[dim])).clone()
    net.__class__ = _PARALLEL[type(net)]
    net.model, net.whole = model, whole
    return net


@torch.no_grad()
def gather_state(net: TensorParallel) -> Dict[str, torch.Tensor]:
    """The whole tensors of the tensor-parallel ``net``, by state-dict name
    (one all-reduce over its model row: every rank of it calls this);
    replicated tensors are the net's own."""
    tensors = dict(_tensors(net))
    names = list(net.whole)
    found = gather_tensors([(tensors[n], *net.whole[n]) for n in names],
                           net.model) if names else []
    tensors.update(zip(names, found))
    return tensors


@torch.no_grad()
def gather_module(net: TensorParallel,
                  out: Optional[nn.Module] = None) -> nn.Module:
    """The whole plain net of the tensor-parallel ``net``: copied into
    ``out`` (a whole net of the family, as this returns) where given, a
    new net otherwise.  Every rank of the model row calls it."""
    tensors = gather_state(net)
    if out is not None:
        for name, t in _tensors(out):
            t.copy_(tensors[name])
        return out
    out = copy.deepcopy(net)
    out.__class__ = _PLAIN[type(net)]
    del out.model, out.whole
    for name, t in _tensors(out):
        t.data = tensors[name].clone()
    return out


def shard_train_state(state, model: ModelGroup):
    """Slices a whole ``learn.rnad.TrainState`` into this rank's shards, in
    place: the four nets (``shard_module``) and Adam's moments, shaped like
    the learner's shards.  ``rnad_tpu``'s ``place_state`` under
    ``model_parallel_mlp``."""
    dims = [shard_dim(state.net, n, p)
            for n, p in state.net.named_parameters()]
    for name in NETS:
        shard_module(getattr(state, name), model)
    for moments in (state.opt.mu, state.opt.nu):
        moments[:] = [t if d is None else
                      t.narrow(d, *model.part(t.shape[d])).clone()
                      for t, d in zip(moments, dims)]
    return state


def gather_train_state(state):
    """A ``TrainState`` of whole plain nets and whole Adam moments of the
    tensor-parallel ``state`` (what a checkpoint holds); the generator and
    the counts are the state's own.  Every rank of the model row calls
    it."""
    names = [n for n, _ in state.net.named_parameters()]
    parts = [(i, *state.net.whole[n]) for i, n in enumerate(names)
             if n in state.net.whole]
    moments = []
    for m in (state.opt.mu, state.opt.nu):
        whole = list(m)
        found = gather_tensors([(m[i], d, n) for i, d, n in parts],
                               state.net.model) if parts else []
        for (i, _, _), t in zip(parts, found):
            whole[i] = t
        moments.append(whole)
    return dataclasses.replace(
        state, **{n: gather_module(getattr(state, n)) for n in NETS},
        opt=dataclasses.replace(state.opt, mu=moments[0], nu=moments[1]))


def model_sums(net: nn.Module, squares: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Per-parameter sums (``net.parameters()`` order) of a global norm:
    a tensor-parallel net's sharded entries summed over its model row in
    one all-reduce, its replicated ones (equal on every rank) counted once;
    a plain net's as they are."""
    if not isinstance(net, TensorParallel):
        return squares
    idx = [i for i, (n, _) in enumerate(net.named_parameters())
           if n in net.whole]
    out = list(squares)
    if idx:
        summed = net.model.global_sum(torch.stack([squares[i] for i in idx]))
        for k, i in enumerate(idx):
            out[i] = summed[k]
    return out
