"""Node-sharded exact NashConv: the backward induction of
``nashconv.nashconv_pure`` with the node axis split over the ranks of a
data-parallel group.

Counterpart of ``rnad_tpu/metrics/nashconv_shard.py``.  One device's
NashConv holds the whole (T, A, A, S) node-minor table and the policy and
value vectors; here each rank holds a contiguous block of ``S_pad / world``
nodes (``S_pad = ceil(S / world) * world``, the pad nodes having no legal
action), computes its block's best-response values each pass, and the two
(S_pad,) value vectors are made whole again (children live on any rank).
The tables are prepared on the host in numpy from the tree, and only this
rank's block goes to its device.

Each node has exactly one parent cell (tree property), so a pass writes the
whole value vector into the rank's cells through a local-parent-cell table:
node j's entry is its parent cell's index in this rank's flattened (T, A,
A, S_pad / world) block, or the dump slot ``n_loc`` past its end where the
cell lies on another rank (node 0, the absorbing state, always dumps).  The
dump slot takes every such write and is dropped, so the values do not
depend on the order of the writes.

The per-pass ``all_gather`` of ``rnad_tpu`` is an ``all_reduce(SUM)`` of a
zero-filled (2, S_pad) tensor into which each rank writes its own block:
gloo runs no ``all_gather`` on CUDA tensors, and one code path serves NCCL
and gloo.  For finite values, adding the other ranks' zeros is exact, so
the sum equals the tiled all-gather bit for bit; the ``has_r`` / ``has_c``
guards pin the pad nodes (which have no legal action) to 0, so no block
holds the -1e30 of an empty maximum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..env.tree import GameTree
from ..parallel.mesh import DataGroup
from .nashconv import _NEG_INF, NashConvResult


def _pad_nodes(x: np.ndarray, s_pad: int) -> np.ndarray:
    """Pads the leading node axis with zero nodes (no legal actions)."""
    S = x.shape[0]
    if S == s_pad:
        return x
    return np.concatenate(
        [x, np.zeros((s_pad - S,) + x.shape[1:], x.dtype)], axis=0)


def local_parent_cells(index: np.ndarray, rank: int, sd: int,
                       s_pad: int) -> np.ndarray:
    """(S_pad,) node j's parent cell in rank ``rank``'s flattened (T, A, A,
    sd) block, or the dump slot ``T * A * A * sd`` where another rank owns
    it (or j has no parent)."""
    T, A = index.shape[1], index.shape[2]
    n_loc = T * A * A * sd
    parent, t, r, c = np.nonzero(index > 0)
    child = index[parent, t, r, c].astype(np.int64)
    mine = (parent // sd) == rank
    cell3 = (t * A + r) * A + c  # the (t, r, c) part of the node-minor cell
    table = np.full((s_pad,), n_loc, np.int64)
    table[child[mine]] = cell3[mine] * sd + (parent[mine] - rank * sd)
    return table


@torch.no_grad()
def nashconv_sharded(tree: GameTree, joint_policy: torch.Tensor,
                     group: DataGroup,
                     num_passes: Optional[int] = None) -> NashConvResult:
    """Best-response values of every node under the joint policy (S, 2A),
    the node axis split over ``group``'s ranks; every rank must call it,
    and every rank returns the whole (S,) vectors, on its device.  Equal
    to ``nashconv.nashconv_root`` up to summation order, with the root's
    reach as the only reach probability (``rnad_tpu``'s result)."""
    if num_passes is None:
        num_passes = tree.max_depth
    n, rank, dev = group.world, group.rank, group.device
    A = tree.max_actions
    S = tree.size
    s_pad = -(-S // n) * n
    sd = s_pad // n
    block = slice(rank * sd, (rank + 1) * sd)

    # -- host (numpy) preparation of this rank's block ---------------------
    host = lambda x: x.detach().cpu().numpy()
    nodes = lambda x: _pad_nodes(host(x[block.start:block.stop]), sd)
    nm = lambda x: np.ascontiguousarray(np.transpose(x, (1, 2, 3, 0)))
    chance_l = nm(nodes(tree.chance))  # (T, A, A, sd) node-minor
    value_l = nm(nodes(tree.value))
    internal_l = nm(nodes(tree.index)) > 0
    legal = nodes(tree.legal)
    jp = nodes(joint_policy)
    legal_r = np.ascontiguousarray(legal[:, 0, :, 0].T)  # (A, sd)
    legal_c = np.ascontiguousarray(legal[:, 0, 0, :].T)
    pi_row = np.where(legal_r > 0, jp[:, :A].T, 0.0).astype(np.float32)
    pi_col = np.where(legal_c > 0, jp[:, A:].T, 0.0).astype(np.float32)
    local_pc = local_parent_cells(host(tree.index), rank, sd, s_pad)

    put = lambda x: torch.from_numpy(x).to(dev)
    chance_l, value_l, internal_l = put(chance_l), put(value_l), \
        put(internal_l)
    legal_r, legal_c, pi_row, pi_col = (put(legal_r), put(legal_c),
                                        put(pi_row), put(pi_col))
    local_pc = put(local_pc)
    shape_l = internal_l.shape
    n_loc = internal_l.numel()
    zero1 = torch.zeros((1,), dtype=value_l.dtype, device=dev)
    base_row = torch.cat([torch.where(internal_l, 0.0, value_l).reshape(-1),
                          zero1])
    base_col = torch.cat([torch.where(internal_l, 0.0, -value_l).reshape(-1),
                          zero1])
    has_r = legal_r.sum(0) > 0  # guards pad nodes and the absorbing state
    has_c = legal_c.sum(0) > 0
    neg_inf = torch.full_like(legal_r, _NEG_INF)

    def children(base, best):
        cells = base.clone()
        cells[local_pc] = best
        return cells[:n_loc].reshape(shape_l)

    best = torch.zeros((2, s_pad), dtype=value_l.dtype, device=dev)
    for _ in range(num_passes):
        row_mat = (chance_l * children(base_row, best[0])).sum(0)
        col_mat = (chance_l * children(base_col, best[1])).sum(0)
        row_resp = torch.einsum("rcs,cs->rs", row_mat, pi_col)
        col_resp = torch.einsum("rs,rcs->cs", pi_row, col_mat)
        rb = torch.where(legal_r > 0, row_resp, neg_inf).amax(0)
        cb = torch.where(legal_c > 0, col_resp, neg_inf).amax(0)
        best = torch.zeros_like(best)
        best[0, block] = torch.where(has_r, rb, 0.0)
        best[1, block] = torch.where(has_c, cb, 0.0)
        best = group.global_sum(best)
        best[:, 0] = 0.0  # absorbing state: value 0 by convention
    reach = torch.zeros((S,), dtype=best.dtype, device=dev)
    reach[1] = 1.0
    return NashConvResult(row_best=best[0, :S], col_best=best[1, :S],
                          reach_probability=reach)
