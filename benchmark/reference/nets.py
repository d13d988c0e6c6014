"""What the plain forwards share: the products' precision and plain RM+;
and each net family's forward, found by name.

A family is ``families/<type>.py`` (the configuration's net type in lower
case), written from the architecture's description (``rnad_tpu/models/
nets.py``, the flax modules the port follows), with ``forward(params,
obs, net, prec, feats, state=None, train=False, mask=None)``,
``features(net, obs, solver)`` (what every pass over the same
observations shares, or None), ``param_shapes(net, A, in_channels)`` and,
where the net keeps state that is not trained (BatchNorm's running
averages), ``state_shapes(net, A, in_channels)``.  A net is a dict of
float32 parameter tensors under the program's state_dict names (a
Linear's weight is (out, in)), and its state another such dict; its
forward computes in the configuration's precision as flax's ``dtype``
does: each layer casts its input, kernel and bias to the compute type and
computes in it, and the outputs leave as float32.  ``train`` is the
learner's pass: its per-sample ``mask`` (N,) weighs the batch statistics,
and the pass moves ``state`` in place, outside autograd; otherwise the
pass reads ``state``.  Observations have ``in_channels`` channels: 2 raw,
or the lift's C + 1 (``in_channels``).

``Precision`` names the type of the products: "float32" (TF32 off),
"bfloat16", and for the control, the type below the one stated: "tf32"
(float32 operands rounded to TF32's 10-bit mantissa) and "fp8" (operands
scaled per tensor into float8 e4m3 and back, then a bfloat16 product).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]
COMPUTE = {"float32": torch.float32, "tf32": torch.float32,
           "bfloat16": torch.bfloat16, "fp8": torch.bfloat16}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (its largest
    magnitude to 448), returned in bfloat16."""
    x = x.float()
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return ((x * scale).to(torch.float8_e4m3fn).float() / scale).to(
        torch.bfloat16)


class _Rounded(torch.autograd.Function):
    """x @ w with every operand rounded by ``rnd``, forward and backward,
    as a product in that type computes."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        ctx.save_for_backward(x, w)
        ctx.rnd = rnd
        return rnd(x) @ rnd(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rnd = ctx.rnd
        gx = rnd(g) @ rnd(w).transpose(-1, -2)
        gw = rnd(x).transpose(-1, -2) @ rnd(g)
        while gw.dim() > w.dim():  # the batch dims of a broadcast product
            gw = gw.sum(0)
        return gx.to(x.dtype), gw.to(w.dtype), None


class Precision:
    """The products' type (module docstring)."""

    def __init__(self, name: str):
        if name not in COMPUTE:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = COMPUTE[name]

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _tf32(x.float())
        if self.name == "fp8":
            return _fp8(x)
        return x.to(self.dtype)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w in this precision (x (..., K), w (K, N))."""
        if self.name in ("tf32", "fp8"):
            return _Rounded.apply(x, w, self.operand)
        return self.operand(x) @ self.operand(w)

    def dense(self, x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
        """A Linear layer (weight (out, in)) in this precision."""
        return self.mm(x, weight.t()) + bias.to(self.dtype)


# ---------------------------------------------------------------------------
# RM+
# ---------------------------------------------------------------------------


def _normalize(q: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    q = q * legal
    s = q.sum(0, keepdim=True)
    uniform = legal / torch.clamp(legal.sum(0, keepdim=True), min=1.0)
    return torch.where(s > 0, q / torch.clamp(s, min=1e-30), uniform)


@torch.no_grad()
def rmplus(M: torch.Tensor, lr: torch.Tensor, lc: torch.Tensor, iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alternating RM+ with linear averaging, batch-minor: M (R, C, B)
    with illegal cells zeroed, masks lr (R, B), lc (C, B) -> x (R, B),
    y (C, B), v (B,) (``rnad_tpu/env/solver_device.py::rmplus_core``)."""
    R, C, B = M.shape
    qr = M.new_zeros((R, B))
    qc = M.new_zeros((C, B))
    xsum, ysum = torch.zeros_like(qr), torch.zeros_like(qc)
    for i in range(iters):
        y = _normalize(qc, lc)
        u_r = (M * y[None]).sum(1)
        v_r = (_normalize(qr, lr) * u_r).sum(0, keepdim=True)
        qr = torch.clamp(qr + (u_r - v_r) * lr, min=0.0)
        x = _normalize(qr, lr)
        u_c = -(M * x[:, None]).sum(0)
        v_c = (y * u_c).sum(0, keepdim=True)
        qc = torch.clamp(qc + (u_c - v_c) * lc, min=0.0)
        y = _normalize(qc, lc)
        xsum = xsum + (i + 1.0) * x
        ysum = ysum + (i + 1.0) * y
    x, y = _normalize(xsum, lr), _normalize(ysum, lc)
    return x, y, (x[:, None] * M * y[None]).sum((0, 1))


@torch.no_grad()
def solve(M: torch.Tensor, lr: torch.Tensor, lc: torch.Tensor, iters: int,
          dtype: torch.dtype = torch.float32):
    """RM+ of (N, R, C) payoffs under legal rows (N, R) and columns (N, C),
    batch-major: (x (N, R), y (N, C), v (N,)), computed in ``dtype``."""
    Mz = (M * lr[:, :, None] * lc[:, None, :]).permute(1, 2, 0)
    x, y, v = rmplus(Mz.to(dtype).contiguous(), lr.t().to(dtype).contiguous(),
                     lc.t().to(dtype).contiguous(), iters)
    return x.t().float(), y.t().float(), v.float()


def family(net: dict) -> ModuleType:
    """The plain family of ``net`` (a configuration's ``net`` group)."""
    name = net["type"].lower()
    try:
        return importlib.import_module(f"{__package__}.families.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.families.{name}":
            raise
        raise ValueError(f"no reference of a {net['type']}: add "
                         f"benchmark/reference/families/{name}.py") from None


def features(net: dict, obs: torch.Tensor, solver=None):
    """What every pass over ``obs`` shares (the family's ``features``)."""
    return family(net).features(net, obs, solver)


def in_channels(config: dict) -> int:
    """The channels of the observations a configuration's net reads: its
    lift's C + 1, or 2 raw."""
    lift = config.get("rnad", {}).get("obs_transform", {})
    return lift["channels"] + 1 if lift.get("kind") == "lift" else 2


def param_shapes(net: dict, A: int, in_channels: int = 2):
    """The trained leaves of a net of ``net`` at A actions reading
    ``in_channels`` channels, in the program's state_dict order: (name,
    shape, bound), where a leaf starts U(-bound, bound), a bound of 0 at 0
    and a bound of None at 1 (a gate, a BatchNorm scale)."""
    return family(net).param_shapes(net, A, in_channels)


def state_shapes(net: dict, A: int, in_channels: int = 2):
    """The leaves a net of ``net`` keeps but does not train, in the
    program's state_dict order: (name, shape, (low, high)), each drawn
    U(low, high); none where the family keeps none."""
    shapes = getattr(family(net), "state_shapes", None)
    return [] if shapes is None else shapes(net, A, in_channels)
