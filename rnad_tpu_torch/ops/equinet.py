"""Kernel K4: the EquiNet's no-grad forwards in one launch.

The learner's three frozen nets (the EMA target and the regularization
pair) run their whole forwards over the same observations without a
gradient, and so do the rollout's net in every generic turn and exact
NashConv's net over the tree; ``equinet_frozen`` runs one to three such
forwards of ``nets.EquiNet``s in bfloat16 as one kernel
(``csrc/equinet.cu``), which keeps every (N, A, A, C) activation in shared
memory and writes only the nets' logits and the values asked for.
It replaces no TPU kernel: ``rnad_tpu`` leaves the EquiNet to XLA, which
fuses the layers' broadcast adds, where the port's eager forward makes a
memory pass for each.

The kernel keeps ``EquiNet.forward``'s dtypes and rounding points (the
module docstring of the source lists them); only the order of the float32
sums inside a product is its own, so an output may differ from the eager
forward's by a bfloat16 rounding where a sum lies near a rounding tie.

``unsupported`` names what the kernel does not take, CPU tensors
included (the learner then keeps the eager passes); the caller checks it
once and then calls ``equinet_frozen``, which launches the kernel.
``forward_no_grad`` is one net's ``net(obs)`` through that gate, for the
rollout and NashConv.  ``pack`` lays the nets' parameters out as the
kernel reads them, once for a rollout's turns (``packed_params``).
``equinet_frozen_plain`` is the nets' own forwards.
``equinet_frozen.launches`` counts the launches.

Kernel K5 (``equinet_backward``, in the same source) is the backward of one
trainable net's forward: ``forward_train`` is ``net(obs, feats)`` as one
autograd function (``EquiNetTrain``) whose forward is a K4 launch that
saves only its inputs and the packed parameters, and whose backward is
one K5 launch that recomputes each tile's forward with K4's tile code and
takes the gradient back through it on chip, then one launch that adds the
blocks' partial sums in a fixed order: a float32 gradient for each of the
net's ``leaves``, bf16-valued where the forward casts the leaf to
bfloat16, equal from run to run.  ``backward_unsupported`` names the
shapes K5 does not take (beside ``unsupported``'s); ``trains`` is the
learner's gate.  ``equinet_backward_plain`` is K5's computation in plain
PyTorch: the same recompute, the same pooled gradients and tie split, the
same rounding points in the compute dtype.  ``equinet_backward.launches``
counts K5's launches.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..models import nets as nets_lib
from ..utils import timing
from . import _build

MAX_ACTIONS = 8
MAX_CHANNELS = 128
MAX_INPUT_CHANNELS = 16
MAX_NETS = 3
SOLVER_CHANNELS = 6
# rnad_equinet_frozen(obs, feats, log_x, v_rm, params, per_net, logits,
#                     values, N, A, cobs, C, depth, nets, primed, stream);
# logits and values: arrays of a pointer a net
ARGTYPES = ((ctypes.c_void_p,) * 5
            + (ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int64) + (ctypes.c_int32,) * 6 + (ctypes.c_void_p,))

# rnad_equinet_backward(obs, feats, log_x, v_rm, params, per_net, dlogits,
#                       dvalue, partial, max_blocks, grads, N, A, cobs, C,
#                       depth, primed, stream)
BACKWARD_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int64,)
                     + (ctypes.c_void_p,) * 3 + (ctypes.c_int32,
                                                 ctypes.c_void_p,
                                                 ctypes.c_int64)
                     + (ctypes.c_int32,) * 5 + (ctypes.c_void_p,))
MAX_TRAIN_CHANNELS = 64
# the 16-row slices of the kernels' weight gradients that K5's threads hold
# in registers, four a warp of its 8
MAX_TRAIN_SLICES = 32

# each net's (logits (N, A), values (N,) or None)
_Outputs = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def input_channels(net: nets_lib.EquiNet) -> int:
    """c0: the observation's channels and the solver's six."""
    return net.ex0.kernel.shape[0] // 6


def leaves(net: nets_lib.EquiNet) -> List[torch.Tensor]:
    """The net's parameters in the order the kernel reads them: each
    layer's kernel (6 C_in, C) and bias, the policy head's weight and bias,
    the value head's, and the gates where primed."""
    out = []
    for i in range(net.depth):
        layer = getattr(net, f"ex{i}")
        out += [layer.kernel, layer.bias]
    out += [net.policy.weight, net.policy.bias, net.value.weight,
            net.value.bias]
    if net.primed:
        out += [net.policy_prime_gate, net.value_prime_gate]
    return out


def unsupported(nets: Sequence[torch.nn.Module], obs: torch.Tensor,
                solver_feats, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel cannot run these nets' forwards, or None.  It takes
    ``nets.EquiNet``s of one shape (not a subclass, such as the
    tensor-parallel one, whose kernels are shards), in bfloat16, with
    A <= 8, C a multiple of 16 up to 128, at most 16 input channels, depth
    1 or more, float32 parameters, float32 or bfloat16 observations, and the
    solver features given where the net has them, all on a CUDA card."""
    if not 1 <= len(nets) <= MAX_NETS:
        return f"{len(nets)} nets (1 to {MAX_NETS})"
    first = nets[0]
    if any(type(net) is not nets_lib.EquiNet for net in nets):
        return "not plain EquiNets"
    key = lambda n: (n.max_actions, n.channels, n.depth, n.solver_iters,
                     n.primed, input_channels(n))
    if any(key(net) != key(first) for net in nets):
        return "nets of different shapes"
    if dtype != torch.bfloat16:
        return f"dtype {dtype} (the kernel computes in bfloat16)"
    A, C, c0 = first.max_actions, first.channels, input_channels(first)
    if not 1 <= A <= MAX_ACTIONS:
        return f"A = {A} (at most {MAX_ACTIONS})"
    if C % 16 or not 16 <= C <= MAX_CHANNELS:
        return f"C = {C} (a multiple of 16 up to {MAX_CHANNELS})"
    if c0 > MAX_INPUT_CHANNELS:
        return f"{c0} input channels (at most {MAX_INPUT_CHANNELS})"
    if first.depth < 1:
        return "depth 0"
    if any(p.dtype != torch.float32 for net in nets for p in leaves(net)):
        return "parameters not float32"
    cobs = c0 - (SOLVER_CHANNELS if first.solver_iters else 0)
    if (obs.dim() != 4 or tuple(obs.shape[1:]) != (cobs, A, A)
            or obs.dtype not in (torch.float32, torch.bfloat16)):
        return (f"observations {tuple(obs.shape)} {obs.dtype} (want (N, "
                f"{cobs}, {A}, {A}) float32 or bfloat16)")
    if first.solver_iters:
        if solver_feats is None:
            return "no solver features"
        N = obs.shape[0]
        want = ((N, A, A, SOLVER_CHANNELS), (N, A), (N,))
        if (tuple(tuple(t.shape) for t in solver_feats) != want
                or any(t.dtype != torch.float32 or t.device != obs.device
                       for t in solver_feats)):
            return "solver features not (N, A, A, 6), (N, A), (N,) float32"
    if any(p.device != obs.device for net in nets for p in leaves(net)):
        return "nets and observations on different devices"
    if obs.device.type != "cuda":
        return f"observations on {obs.device.type} (the kernel runs on CUDA)"
    return None


@torch.no_grad()
def equinet_frozen_plain(nets: Sequence[nets_lib.EquiNet],
                         obs: torch.Tensor, solver_feats,
                         dtype: torch.dtype,
                         values: Optional[Sequence[bool]] = None
                         ) -> _Outputs:
    """The nets' own forwards: each net's (logits (N, A), values (N,)),
    the values None where ``values`` (a flag a net) is False."""
    keep = list(values or [True] * len(nets))
    return [(lg, v if k else None) for (lg, v), k in
            zip((net(obs, solver_feats, dtype=dtype) for net in nets), keep)]


def operations(n: int, A: int, C: int, depth: int, c0: int,
               nets: int = 3) -> int:
    """Products of ``nets`` forwards over n observations, an FMA counting
    two: each layer's six block products (n A^2 cell rows, n A rows of
    each of the row and column means and maxes, n global rows) of depth
    C_in against C, and the heads' dots (n A policy rows and n value rows
    of C + c0)."""
    rows = n * (A * A + 4 * A + 1)
    tower = sum(2 * rows * cin * C for cin in [c0] + [C] * (depth - 1))
    heads = 2 * n * A * (C + c0) + 2 * n * (C + c0)
    return nets * (tower + heads)


def io_bytes(n: int, A: int, C: int, depth: int, cobs: int, c0: int,
             nets: int = 3, obs_bytes: int = 4, primed: bool = True) -> int:
    """Bytes that must cross device memory: the observations, the solver
    features, log x and v (primed), every net's float32 parameters read
    once, and every net's logits and values written once."""
    params = (sum(6 * cin * C + C for cin in [c0] + [C] * (depth - 1))
              + 2 * (C + c0 + 1) + (2 if primed else 0))
    reads = n * cobs * A * A * obs_bytes
    if c0 > cobs:
        reads += 4 * n * A * A * SOLVER_CHANNELS
    if primed:
        reads += 4 * n * (A + 1)
    return reads + 4 * nets * params + 4 * nets * n * (A + 1)


@torch.no_grad()
def pack(nets: Sequence[nets_lib.EquiNet]) -> torch.Tensor:
    """The nets' float32 parameters as the kernel reads them: each net's
    ``leaves``, flattened, one net after the other."""
    return torch.cat([t.detach().reshape(-1) for net in nets
                      for t in leaves(net)])


def packed_params(net) -> Optional[torch.Tensor]:
    """``pack([net])`` where the kernel may take ``net`` (a plain bfloat16
    EquiNet on a CUDA card), else None: a rollout packs its net once for
    all its turns."""
    if (type(net) is nets_lib.EquiNet and net.dtype == torch.bfloat16
            and net.ex0.kernel.is_cuda):
        return pack([net])
    return None


def equinet_frozen(nets: Sequence[nets_lib.EquiNet], obs: torch.Tensor,
                   solver_feats, dtype: torch.dtype,
                   values: Optional[Sequence[bool]] = None,
                   params: Optional[torch.Tensor] = None) -> _Outputs:
    """The EquiNets' forwards over ``obs`` (N, c, A, A) with the solver
    features ``solver_feats`` (from ``nets.equinet_solver_features``, or
    None for a net without them) in ``dtype``, as the nets' own forwards
    return them: each net's (logits (N, A), values (N,)), float32, in
    tensors of its own; ``values``, a flag a net, leaves out (None) the
    values that are not read.  ``params`` is ``pack(nets)``, packed here
    where it is not given.  The caller has checked that ``unsupported``
    names nothing here."""
    keep = list(values or [True] * len(nets))
    if len(keep) != len(nets):
        raise ValueError("equinet_frozen: one values flag a net")
    first = nets[0]
    N, cobs, A = obs.shape[0], obs.shape[1], first.max_actions
    dev = obs.device
    if params is None:
        params = pack(nets)
    out = [(torch.empty((N, A), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.float32, device=dev) if k else None)
           for k in keep]
    if N == 0:
        return out
    obs = obs.float().contiguous()  # bf16 observations widen exactly
    feats = log_x = v_rm = None
    if first.solver_iters:
        feats, log_x, v_rm = (t.contiguous() for t in solver_feats)
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[ptr(t) for t in ts])
    logits_p, values_p = ptrs([o[0] for o in out]), ptrs([o[1] for o in out])
    fn = _build.entry("equinet", "rnad_equinet_frozen", ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(obs.data_ptr(), ptr(feats),
                 ptr(log_x) if first.primed else None,
                 ptr(v_rm) if first.primed else None, params.data_ptr(),
                 params.numel() // len(nets), ctypes.addressof(logits_p),
                 ctypes.addressof(values_p), N, A, cobs, first.channels,
                 first.depth, len(nets), int(first.primed), stream)
    _build.check("equinet", "rnad_equinet_frozen", err)
    equinet_frozen.launches += 1
    return out


equinet_frozen.launches = 0  # kernel launches


def solver_features(net, obs: torch.Tensor):
    """The solver features ``EquiNet.forward`` computes for ``obs`` (N, c,
    A, A) (from its first two channels, lifted or not), or None for a net
    without them."""
    if isinstance(net, nets_lib.EquiNet) and net.solver_iters:
        return nets_lib._solver_features(obs.permute(0, 2, 3, 1),
                                         net.solver_iters)
    return None


@torch.no_grad()
def forward_no_grad(net, obs: torch.Tensor,
                    params: Optional[torch.Tensor] = None,
                    span: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``net(obs)`` returns (any callable net), float32 logits (N, A)
    and values (N,), without a gradient: one K4 launch where
    ``unsupported`` names nothing for the net alone in its own dtype
    (inside the span ``span``, where one is named; ``params`` is
    ``pack([net])`` where the caller packed it), else the net's own
    forward on the same solver features."""
    feats = solver_features(net, obs)
    if unsupported([net], obs, feats, getattr(net, "dtype", None)):
        return net(obs) if feats is None else net(obs, feats)
    with timing.span(span) if span else contextlib.nullcontext():
        [(logits, values)] = equinet_frozen([net], obs, feats, net.dtype,
                                            params=params)
    return logits, values


def backward_slices(C: int, depth: int) -> int:
    """The 16-row slices of the kernels' weight gradients: layer 0's six
    blocks (at most 16 input channels each) and six blocks of C / 16 a
    layer after it."""
    return 6 + (depth - 1) * 6 * (C // 16)


def backward_unsupported(net) -> Optional[str]:
    """Why K5 cannot take the backward of ``net``'s forward, where
    ``unsupported([net], ...)`` names nothing, or None: it takes C up to 64
    (its weights resident in shared memory beside a tile's activations
    and their gradients) with at most ``MAX_TRAIN_SLICES`` 16-row slices
    of weight gradient (depth 5 at C = 16, 3 at C = 32, 2 at C = 48 and
    64)."""
    C, depth = net.channels, net.depth
    if C > MAX_TRAIN_CHANNELS:
        return f"C = {C} (the backward takes up to {MAX_TRAIN_CHANNELS})"
    if backward_slices(C, depth) > MAX_TRAIN_SLICES:
        return (f"depth {depth} at C = {C} ({backward_slices(C, depth)} "
                f"weight-gradient slices, at most {MAX_TRAIN_SLICES})")
    return None


def trains(net, obs: torch.Tensor, solver_feats) -> bool:
    """Whether the learner's pass of ``net`` over ``obs`` runs on K4 and
    K5 (``forward_train``): a net both kernels take, in its own dtype."""
    return (unsupported([net], obs, solver_feats,
                        getattr(net, "dtype", None)) is None
            and backward_unsupported(net) is None)


def backward_operations(n: int, A: int, C: int, depth: int, c0: int) -> int:
    """K5's products over n observations, an FMA counting two: the
    recomputed forward, every product's weight gradient (as many as the
    forward's) and the input gradient of every layer after the first (the
    heads' input gradient is a broadcast product, one a tower element)."""
    forward = operations(n, A, C, depth, c0, nets=1)
    rows = n * (A * A + 4 * A + 1)
    inputs = (depth - 1) * 2 * rows * C * C + 2 * n * A * C + 2 * n * C
    return 2 * forward + inputs


def _split(flat: torch.Tensor, net) -> List[torch.Tensor]:
    """``flat`` (``pack([net])``'s layout) as a tensor a leaf."""
    shapes = [leaf.shape for leaf in leaves(net)]
    parts = flat.split([leaf.numel() for leaf in leaves(net)])
    return [part.view(shape) for part, shape in zip(parts, shapes)]


def equinet_backward(net: nets_lib.EquiNet, obs: torch.Tensor,
                     solver_feats, params: torch.Tensor,
                     dlogits: torch.Tensor, dvalue: torch.Tensor
                     ) -> List[torch.Tensor]:
    """The gradient of each of ``net``'s ``leaves`` (float32, the leaf's
    shape) from the gradients ``dlogits`` (N, A) and ``dvalue`` (N,) of
    its forward over ``obs`` with ``solver_feats`` in the net's dtype: one
    K5 launch and one launch that adds its blocks' sums.  ``params`` is
    ``pack([net])``.  The caller has checked that ``trains`` holds."""
    N, cobs = obs.shape[0], obs.shape[1]
    dev = obs.device
    grads = torch.empty((params.numel(),), dtype=torch.float32, device=dev)
    if N == 0:
        return _split(grads.zero_(), net)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((blocks, params.numel()), dtype=torch.float32,
                          device=dev)
    obs = obs.float().contiguous()
    dlogits = dlogits.float().contiguous()
    dvalue = dvalue.float().contiguous()
    feats = log_x = v_rm = None
    if net.solver_iters:
        feats, log_x, v_rm = (t.contiguous() for t in solver_feats)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.entry("equinet", "rnad_equinet_backward", BACKWARD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(obs.data_ptr(), ptr(feats),
                 ptr(log_x) if net.primed else None,
                 ptr(v_rm) if net.primed else None, params.data_ptr(),
                 params.numel(), dlogits.data_ptr(), dvalue.data_ptr(),
                 partial.data_ptr(), blocks, grads.data_ptr(), N,
                 net.max_actions, cobs, net.channels, net.depth,
                 int(net.primed), stream)
    _build.check("equinet", "rnad_equinet_backward", err)
    equinet_backward.launches += 1
    return _split(grads, net)


equinet_backward.launches = 0  # K5 launches (each with its sum)


@torch.no_grad()
def equinet_backward_plain(net: nets_lib.EquiNet, obs: torch.Tensor,
                           solver_feats, dlogits: torch.Tensor,
                           dvalue: torch.Tensor,
                           dtype: Optional[torch.dtype] = None
                           ) -> List[torch.Tensor]:
    """K5's computation in plain PyTorch: ``net``'s forward over ``obs``
    in ``dtype`` (the net's own by default) recomputed with each layer's
    input kept, then the gradient of each leaf taken back by hand as
    autograd takes it through ``EquiNet.forward``, rounding to ``dtype``
    where autograd's bf16 graph rounds: the incoming gradients, each
    product, each pooled sum, each mean's and max's broadcast and each add
    of the input gradient (in the order the engine accumulates them), and
    each leaf's gradient once.  The max pools' gradient splits evenly
    between tied maxima.  Float32 sums in torch's order; in float32 every
    rounding is the identity."""
    dtype = dtype or net.dtype
    rnd = lambda t: t.to(dtype).float()
    A, C, depth = net.max_actions, net.channels, net.depth
    x = obs.permute(0, 2, 3, 1)
    if net.solver_iters:
        feats, log_x, v_rm = solver_feats
        x = torch.cat([x, feats], dim=-1)
    hs = [x.to(dtype)]
    for i in range(depth):
        hs.append(torch.relu(getattr(net, f"ex{i}")(hs[-1], dtype)))
    x0, top = hs[0], hs[-1]
    dl, dv = rnd(dlogits), rnd(dvalue)
    row = torch.cat([top.mean(dim=2), x0.mean(dim=2)], dim=-1).float()
    glob = torch.cat([top.mean(dim=(1, 2)), x0.mean(dim=(1, 2))],
                     dim=-1).float()
    heads = [torch.einsum("naf,na->f", row, dl)[None], dl.sum()[None],
             torch.einsum("nf,n->f", glob, dv)[None], dv.sum()[None]]
    wp, wv = rnd(net.policy.weight[0, :C]), rnd(net.value.weight[0, :C])
    d_row = rnd(rnd(dl[..., None] * wp) * (1.0 / A))  # (N, A, C)
    d_glob = rnd(rnd(dv[:, None] * wv) * (1.0 / (A * A)))  # (N, C)
    dz = rnd(d_row[:, :, None] + d_glob[:, None, None])
    dz = torch.where(top.float() > 0, dz, torch.zeros_like(dz))
    layers = [None] * depth
    for l in reversed(range(depth)):
        h = hs[l]
        hf, cin = h.float(), h.shape[-1]
        rows_ = rnd(dz.sum(2))  # (N, A, C): the row pools' gradient
        cols_ = rnd(dz.sum(1))
        glob_ = rnd(dz.sum((1, 2)))
        pools = [hf, h.mean(dim=2).float(), h.mean(dim=1).float(),
                 h.mean(dim=(1, 2)).float(), h.amax(dim=2).float(),
                 h.amax(dim=1).float()]
        grads = [dz, rows_, cols_, glob_, rows_, cols_]
        kernel = torch.cat([p.reshape(-1, cin).t() @ g.reshape(-1, C)
                            for p, g in zip(pools, grads)])
        layers[l] = [kernel, dz.sum((0, 1, 2))]
        if l == 0:
            break
        W = rnd(getattr(net, f"ex{l}").kernel)
        prods = [rnd(g @ W[k * cin:(k + 1) * cin].t())
                 for k, g in enumerate(grads)]
        zero = torch.zeros_like(hf)
        ties_r = hf == pools[4][:, :, None]
        ties_c = hf == pools[5][:, None]
        x4 = torch.where(ties_r, rnd(prods[4][:, :, None]
                                     / ties_r.sum(2, keepdim=True)), zero)
        x5 = torch.where(ties_c, rnd(prods[5][:, None]
                                     / ties_c.sum(1, keepdim=True)), zero)
        dh = rnd(x5 + x4)
        dh = rnd(dh + rnd(prods[3] * (1.0 / (A * A)))[:, None, None])
        dh = rnd(dh + rnd(prods[2] * (1.0 / A))[:, None])
        dh = rnd(dh + rnd(prods[1] * (1.0 / A))[:, :, None])
        dh = rnd(dh + prods[0])
        dz = torch.where(hf > 0, dh, zero)
    out = [rnd(g) for layer in layers for g in layer] + [rnd(g)
                                                         for g in heads]
    if net.primed:
        out += [(dlogits * log_x).sum(), (dvalue * v_rm).sum()]
    return out


class EquiNetTrain(torch.autograd.Function):
    """``net(obs, feats)`` with a gradient for each of ``net``'s leaves
    (the trailing inputs): the forward one K4 launch (inside the span
    ``rnad.learn.forward.fused``, with the parameters' pack), saving only
    the observations, the solver features and the pack; the backward one
    K5 launch and its sum (inside ``rnad.learn.backward.fused``)."""

    @staticmethod
    def forward(ctx, net, obs, n_feats, *rest):
        feats = rest[:n_feats] or None
        with timing.span("rnad.learn.forward.fused"):
            params = pack([net])
            [(logits, values)] = equinet_frozen([net], obs, feats, net.dtype,
                                                params=params)
        ctx.net, ctx.n_feats = net, n_feats
        ctx.save_for_backward(obs, params, *rest[:n_feats])
        return logits, values

    @staticmethod
    def backward(ctx, dlogits, dvalue):
        obs, params, *feats = ctx.saved_tensors
        with timing.span("rnad.learn.backward.fused"):
            grads = equinet_backward(ctx.net, obs, feats or None, params,
                                     dlogits, dvalue)
        return (None, None, None) + (None,) * ctx.n_feats + tuple(grads)


def forward_train(net: nets_lib.EquiNet, obs: torch.Tensor, solver_feats
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``net(obs, solver_feats)`` returns, float32 logits (N, A) and
    values (N,), differentiable with respect to every parameter of the
    net: forward on K4, backward on K5 (``EquiNetTrain``).  The caller has
    checked that ``trains`` holds."""
    feats = tuple(solver_feats) if solver_feats is not None else ()
    return EquiNetTrain.apply(net, obs, len(feats), *feats, *leaves(net))
