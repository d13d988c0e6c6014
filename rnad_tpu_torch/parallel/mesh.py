"""The data axis: this process's rank in a ``torch.distributed`` group.

Counterpart of the data half of ``rnad_tpu/parallel/mesh.py``.  In
``rnad_tpu`` a ``('data', 'model')`` device mesh shards environment lanes,
trajectories and per-lane learner tensors over ``data``, and collectives
over that axis combine gradients and metrics.  Here a process is one rank
of the data axis: it holds the replicated weights on its own device and a
contiguous slice of the lanes, and ``DataGroup`` is its handle on the
axis.  ``global_sum`` is the counterpart of ``jax.lax.psum`` over
``DATA_AXIS``, ``global_max`` of ``pmax``, and ``global_sum_grad`` of a
``psum`` that autograd differentiates (the ConvNet's BatchNorm sums over
the global batch).

Every collective is an ``all_reduce`` (or a ``barrier``): the gloo backend
runs ``all_reduce`` and ``broadcast`` on CUDA tensors but not
``all_gather``, and the same code serves NCCL on the card, gloo on the CPU
and gloo between ranks that share one card.  A collective that fails
raises; nothing here catches it.

The tensor-parallel layouts of ``mesh.py:89-156`` (the model axis) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist


class _GlobalSum(torch.autograd.Function):
    """``all_reduce(SUM)`` forward and backward (``DataGroup.
    global_sum_grad``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank of the data axis: its index, the axis size, its device and
    the process group (None: the default group)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def lanes(self, batch_size: int) -> slice:
        """This rank's contiguous slice of ``batch_size`` global lanes;
        raises where they do not divide over the ranks."""
        if batch_size % self.world != 0:
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"{self.world} data-parallel ranks")
        local = batch_size // self.world
        return slice(self.rank * local, (self.rank + 1) * local)

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, as a new tensor that carries no
        gradient (``x`` is left as it is)."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def global_sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable: the backward
        all-reduces (SUM) the incoming gradient, so every rank receives the
        gradient of the *global* loss with respect to the sum.

        Why that is the unsharded gradient under the port's convention
        (``learn.rnad.learn_step``): each rank's loss L_r is its numerator
        over the global count, and ``learn_step`` sums the parameter
        gradients over the ranks.  With s = sum_r' x_r', rank r' receives
        sum_r dL_r/ds and goes on through its own x_r', so the summed
        gradients are d(sum_r L_r)/d(theta): what one rank computes on the
        whole batch.  An identity backward would give each rank only
        dL_r'/ds and lose the other ranks' shares.  Every rank must run the
        backward (the graphs are the same on every rank, so autograd issues
        the all-reduces in the same order).  The only collective here with
        a gradient."""
        return _GlobalSum.apply(x, self.group)

    def global_max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum of ``x`` over the ranks, as a new tensor without
        gradient."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def sum_tensors(self, tensors: Iterable[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, in one ``all_reduce`` of
        their concatenation; returns new tensors of the inputs' shapes."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [part.view_as(t) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    @torch.no_grad()
    def average_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Replaces each tensor by its mean over the ranks (SUM / world),
        in place: ``jax.lax.pmean``."""
        tensors = list(tensors)
        if not tensors:
            return
        for t, s in zip(tensors, self.sum_tensors(tensors)):
            t.copy_(s / self.world)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def host_value(x) -> float:
    """Host float of a scalar (``rnad_tpu``'s ``host_value``).  A value
    every rank computed from replicated or all-reduced tensors is the same
    on each, so the local copy is read."""
    return float(x)
