"""The (data, model) grid: this process's ranks on the two axes of a
``torch.distributed`` world.

Counterpart of ``rnad_tpu/parallel/mesh.py``.  In ``rnad_tpu`` a
``('data', 'model')`` device mesh shards environment lanes, trajectories
and per-lane learner tensors over ``data``, and optionally the nets'
hidden widths or channels over ``model``; GSPMD inserts the collectives.
Here a process is one rank of the world, placed on the grid by
``make_grid`` in ``make_mesh``'s order (the model index runs fastest).
``DataGroup`` is its handle on the data axis: it holds the lanes of its
data coordinate, and ``global_sum`` is the counterpart of
``jax.lax.psum`` over ``DATA_AXIS``, ``global_max`` of ``pmax``, and
``global_sum_grad`` of a ``psum`` that autograd differentiates (the
ConvNet's BatchNorm sums over the global batch).  ``ModelGroup`` is its
handle on the model axis, with the same helpers; the tensor-parallel
layouts and their operators are ``tensor_parallel.py``'s.

Every collective is an ``all_reduce`` (or a ``barrier``): the gloo backend
runs ``all_reduce`` and ``broadcast`` on CUDA tensors but not
``all_gather``, and the same code serves NCCL on the card, gloo on the CPU
and gloo between ranks that share one card.  A collective that fails
raises; nothing here catches it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist


class _GlobalSum(torch.autograd.Function):
    """``all_reduce(SUM)`` forward and backward (``global_sum_grad``)."""

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


class _Axis:
    """The all-reduces over one axis of the grid (``self.group``, of
    ``self.world`` ranks)."""

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, as a new tensor that carries no
        gradient (``x`` is left as it is)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
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


@dataclasses.dataclass(frozen=True)
class DataGroup(_Axis):
    """One rank of the data axis: its data coordinate, the axis size, its
    device and the process group of its data column (None: the default
    group, where the world is one data axis)."""

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


@dataclasses.dataclass(frozen=True)
class ModelGroup(_Axis):
    """One rank of the model axis: its model coordinate, the axis size and
    the process group of its model row (the ranks that hold the other
    shards of its weights).  The tensor-parallel nets hold it; a copy of a
    net shares it (a handle on a communicator is not copied)."""

    rank: int
    world: int
    group: Optional[dist.ProcessGroup] = None

    def __deepcopy__(self, memo) -> "ModelGroup":
        return self

    def part(self, size: int) -> Tuple[int, int]:
        """(offset, length) of this rank's shard of a dimension of
        ``size``: ``torch.tensor_split``'s, whose first ``size % world``
        shards hold one more (GSPMD pads an uneven split rather than
        refusing it)."""
        base, extra = divmod(size, self.world)
        return (self.rank * base + min(self.rank, extra),
                base + (self.rank < extra))


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the (data, model) grid: world rank
    ``data.rank * model.world + model.rank``."""

    data: DataGroup
    model: ModelGroup

    @property
    def rank(self) -> int:
        return self.data.rank * self.model.world + self.model.rank

    @property
    def device(self) -> torch.device:
        return self.data.device

    def barrier(self) -> None:
        """A barrier of the whole world."""
        dist.barrier()


def make_grid(model_parallelism: int, device: torch.device) -> Grid:
    """Splits the initialized world into a (world / m, m) grid, m =
    ``model_parallelism``, in ``make_mesh``'s order: world rank w has data
    coordinate w // m and model coordinate w % m.  Every rank creates every
    sub-group (``new_group`` is collective over the world), the model rows
    first, then the data columns, in one order; raises where m does not
    divide the world."""
    world, rank = dist.get_world_size(), dist.get_rank()
    m = model_parallelism
    if m < 1 or world % m != 0:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallelism={m}")
    d = world // m
    rows = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    cols = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    i, j = divmod(rank, m)
    return Grid(data=DataGroup(i, d, device, cols[j]),
                model=ModelGroup(j, m, rows[i]))


def host_value(x) -> float:
    """Host float of a scalar (``rnad_tpu``'s ``host_value``).  A value
    every rank computed from replicated or all-reduced tensors is the same
    on each, so the local copy is read."""
    return float(x)
