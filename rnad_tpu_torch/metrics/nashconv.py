"""Exact exploitability (NashConv) of a joint policy on a game tree.

Counterpart of ``rnad_tpu/metrics/nashconv.py``: level-synchronous backward
induction.  Every pass recomputes all nodes' best-response values from
their children's, so after ``max_depth`` passes the root values are exact
(a depth-d node is right after pass d).  NashConv(root) = row_best[1] +
col_best[1]; it is 0 iff the joint policy is a Nash equilibrium, which the
generator's stored solution is.

A net's joint policy comes from one whole-tree pass
(``joint_policy_all_nodes``) or, on large trees, from chunked inference
(``joint_policy_from_net``) that feeds the same backward induction; under
an observation transform the net is wrapped by ``lifted``.

Child values reach their parent cells by a scatter of the S node values:
every internal node has exactly one parent cell (tree property).  Only the
``index > 0`` cells are scattered, so no two writes hit one slot (a CUDA
``index_put_`` with duplicate indices is nondeterministic).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..env.tree import GameTree
from ..models import common
from ..ops import equinet as equinet_lib
from ..ops.stepping import seat_observations

_NEG_INF = -1e30


@dataclasses.dataclass
class NashConvResult:
    row_best: torch.Tensor  # (S,) row player's best-response value vs pi_col
    col_best: torch.Tensor  # (S,) column player's best-response value vs pi_row
    reach_probability: torch.Tensor  # (S,) reach under the joint policy

    def nashconv(self) -> torch.Tensor:
        return self.row_best[1] + self.col_best[1]


@torch.no_grad()
def nashconv_pure(tree: GameTree, joint_policy: torch.Tensor,
                  num_passes: int | None = None,
                  compute_reach: bool = True) -> NashConvResult:
    """Best-response values (and reach probabilities) of every node under
    the joint policy (S, 2A), in the node-minor (T, A, A, S) layout."""
    if num_passes is None:
        num_passes = tree.max_depth
    A = tree.max_actions
    S = tree.index.shape[0]

    chance_t = tree.chance.permute(1, 2, 3, 0)  # (T, A, A, S)
    value_t = tree.value.permute(1, 2, 3, 0)
    index_t = tree.index.permute(1, 2, 3, 0)
    internal_t = index_t > 0
    legal_r = tree.legal[:, 0, :, 0].t()  # (A, S)
    legal_c = tree.legal[:, 0, 0, :].t()
    zero = torch.zeros((), dtype=joint_policy.dtype, device=joint_policy.device)
    pi_row = torch.where(legal_r > 0, joint_policy[:, :A].t(), zero)  # (A, S)
    pi_col = torch.where(legal_c > 0, joint_policy[:, A:].t(), zero)

    shape_t = index_t.shape
    flat_idx = index_t.reshape(-1).long()
    child_cells = torch.nonzero(flat_idx > 0)[:, 0]  # unique parent cells
    child_nodes = flat_idx[child_cells]
    base_row = torch.where(internal_t, torch.zeros_like(value_t),
                           value_t).reshape(-1)
    base_col = -base_row

    def gather_children(base, best):
        cells = base.clone()
        cells[child_cells] = best[child_nodes]
        return cells.reshape(shape_t)

    row_best = torch.zeros((S,), dtype=tree.value.dtype, device=tree.device)
    col_best = torch.zeros_like(row_best)
    for _ in range(num_passes):
        row_mat = (chance_t * gather_children(base_row, row_best)).sum(0)
        col_mat = (chance_t * gather_children(base_col, col_best)).sum(0)
        row_resp = torch.einsum("rcs,cs->rs", row_mat, pi_col)
        col_resp = torch.einsum("rs,rcs->cs", pi_row, col_mat)
        rb = torch.where(legal_r > 0, row_resp,
                         torch.full_like(row_resp, _NEG_INF)).amax(0)
        cb = torch.where(legal_c > 0, col_resp,
                         torch.full_like(col_resp, _NEG_INF)).amax(0)
        rb[0] = 0.0  # absorbing state: value 0 by convention
        cb[0] = 0.0
        row_best, col_best = rb, cb

    reach = torch.zeros((S,), dtype=tree.value.dtype, device=tree.device)
    reach[1] = 1.0
    if compute_reach:
        for _ in range(num_passes):
            contrib = (reach[None, None, None, :]
                       * pi_row[None, :, None, :]
                       * pi_col[None, None, :, :]
                       * chance_t).reshape(-1)
            new = torch.zeros_like(reach)
            new[child_nodes] = contrib[child_cells]
            new[1] = 1.0
            reach = new
    return NashConvResult(row_best=row_best, col_best=col_best,
                          reach_probability=reach)


def nashconv_root(tree: GameTree, joint_policy: torch.Tensor
                  ) -> NashConvResult:
    """Best-response values only (reach skipped), for a precomputed joint
    policy such as chunked inference gives."""
    return nashconv_pure(tree, joint_policy, compute_reach=False)


def _joint_policy(net, ev: torch.Tensor, lg: torch.Tensor) -> torch.Tensor:
    """Both seats' policies (n, 2A) of ``net`` at the nodes whose
    expected values and legality are ``ev`` and ``lg`` (n, 1, A, A), in
    one no-grad forward (``equinet.forward_no_grad``: K4 for a plain bf16
    EquiNet on the card)."""
    row_obs, col_obs = seat_observations(ev, lg)
    obs = torch.cat([row_obs, col_obs], dim=0)
    logits, _ = equinet_lib.forward_no_grad(net, obs)
    p = common.masked_policy(logits, obs[:, 1, :, 0])
    n = ev.shape[0]
    return torch.cat([p[:n], p[n:]], dim=-1)


def lifted(net, obs_transform=None):
    """``net`` as the policy functions below call it, behind the noise-free
    lift of ``obs_transform`` (``ops/obs_transform.py``) where one is given:
    exact evaluation scores the policy the net induces on the mean
    observation.  Legality is still read from the raw observation."""
    if obs_transform is None:
        return net
    return lambda obs: net(obs_transform.apply(obs, None))


@torch.no_grad()
def joint_policy_all_nodes(tree: GameTree, net) -> torch.Tensor:
    """Whole-tree both-seat policy (S, 2A) of ``net`` in one pass."""
    return _joint_policy(net, tree.expected_value, tree.legal)


@torch.no_grad()
def joint_policy_from_net(tree: GameTree, net,
                          inference_batch_size: int = 100_000
                          ) -> torch.Tensor:
    """Both-seat policy (S, 2A) of ``net`` for every node, in chunks of
    ``inference_batch_size`` nodes, so a large tree's inference fits in
    memory (one forward, and for a solver EquiNet one RM+ solve, a chunk).
    The tail chunk is zero-padded to the chunk's size with one legal cell
    per padded node, as ``rnad_tpu`` pads it to its compiled shape."""
    S = tree.index.shape[0]
    chunk = min(inference_batch_size, S)
    outs = []
    for start in range(0, S, chunk):
        stop = min(start + chunk, S)
        ev = tree.expected_value[start:stop]
        lg = tree.legal[start:stop]
        if stop - start < chunk:
            pad = chunk - (stop - start)
            ev = torch.nn.functional.pad(ev, (0, 0, 0, 0, 0, 0, 0, pad))
            lg = torch.nn.functional.pad(lg, (0, 0, 0, 0, 0, 0, 0, pad))
            lg[stop - start:, 0, 0, 0] = 1.0  # keep the softmax sane
        outs.append(_joint_policy(net, ev, lg)[:stop - start])
    return torch.cat(outs, dim=0)


def mean_nashconv_by_depth(tree: GameTree,
                           result: NashConvResult) -> Dict[int, float]:
    """Per-depth mean exploitability; depth is the longest distance to a
    terminal, so the root has the maximum depth."""
    depth = tree.depth.cpu().numpy()
    total = (result.row_best + result.col_best).cpu().numpy()
    means: Dict[int, float] = {}
    for d in range(1, tree.max_depth + 1):
        sel = depth == d
        if sel.any():
            means[d] = float(np.mean(total[sel]))
    return means


def kld_sums(p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
             legal_actions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kld``'s numerator and valid count, which data-parallel ranks sum
    before they divide."""
    sel = (valid.unsqueeze(-1) * legal_actions) > 0
    safe = lambda x: torch.log(torch.clamp(x, min=1e-30))
    terms = torch.where(sel, p * (safe(p) - safe(q)), torch.zeros_like(p))
    return terms.sum(), valid.sum()


def kld(p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
        legal_actions: torch.Tensor) -> torch.Tensor:
    """Masked KL divergence diagnostic over (T, B, A) policies."""
    total, count = kld_sums(p, q, valid, legal_actions)
    return total / torch.clamp(count, min=1.0)
