"""Supervised oracle distillation: the architecture's NashConv floor.

Counterpart of ``rnad_tpu/learn/supervised.py``.  Every tree node, for
both seats, is one labeled example: the cross-entropy of the net's masked
log-policy against the stored exact NE strategy plus the squared error of
its value against the stored exact game value (+v for the row seat, -v for
the column seat), trained full-batch or on node minibatches with Adam at
optax's defaults.  The distilled policy's exact NashConv is the floor of
that architecture on that tree: pure function-approximation error with
perfect labels, apart from R-NaD's learning dynamics.

A solver EquiNet runs its RM+ solve (kernel K3 on the card) inside every
forward; the final NashConv goes through chunked inference on trees larger
than ``nets.inference_chunk_nodes``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..env.tree import GameTree
from ..metrics import nashconv as nashconv_lib
from ..models import common, nets
from ..ops.stepping import seat_observations
from .rnad import AdamState, adam_update

# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def dataset(tree: GameTree) -> Tuple[torch.Tensor, ...]:
    """(obs (2S, 2A^2), target_policy (2S, A), target_value (2S,), weight
    (2S,)) over every node and seat, the row seats first.  Observations are
    flat, as rnad_tpu stores them; node 0, the absorbing state, has weight
    0."""
    A = tree.max_actions
    S = tree.index.shape[0]
    row_obs, col_obs = seat_observations(tree.expected_value, tree.legal)
    obs = torch.cat([row_obs, col_obs], 0).reshape(2 * S, 2 * A * A)
    pol = torch.cat([tree.solution[:, :A], tree.solution[:, A:]], 0)
    val = torch.cat([tree.root_value[:, 0], -tree.root_value[:, 0]], 0)
    live = (torch.arange(S, device=tree.device) != 0).to(torch.float32)
    return obs, pol, val, torch.cat([live, live], 0)


def supervised_loss(net: nn.Module, obs_flat: torch.Tensor,
                    target_pol: torch.Tensor, target_val: torch.Tensor,
                    weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted mean cross-entropy of the masked log-policy plus weighted
    mean squared value error, and the two parts."""
    A = net.max_actions
    obs = obs_flat.reshape(-1, 2, A, A)
    logits, value = net(obs)
    log_pi = common.masked_log_policy(logits, obs[:, 1, :, 0])
    ce = -(target_pol * log_pi).sum(-1)
    mse = (value - target_val) ** 2
    n = torch.clamp(weight.sum(), min=1.0)
    loss_pi = (ce * weight).sum() / n
    loss_v = (mse * weight).sum() / n
    return loss_pi + loss_v, {"loss_pi": loss_pi, "loss_v": loss_v}


def train_oracle_net(tree: GameTree, net: nn.Module, steps: int = 2000,
                     lr: float = 1e-3, node_batch: Optional[int] = None,
                     eval_chunk_nodes: Optional[int] = None,
                     scan_segment_steps: int = 1000,
                     generator: Optional[torch.Generator] = None,
                     batch_indices: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[nn.Module, Dict[str, float]]:
    """Distills the tree's exact solution into ``net`` in place; returns
    (net, {"final_loss", "nashconv"}).  ``net`` lies on the tree's device.

    ``node_batch``: each step trains on that many node-seat rows drawn
    uniformly with replacement (``generator``, default seed 0 on the tree's
    device), or on the rows ``batch_indices[step]`` where given (rnad_tpu's
    draws, in the parity tests); None trains full-batch.
    ``eval_chunk_nodes``: trees larger than this evaluate the final NashConv
    by chunked inference (default ``nets.inference_chunk_nodes``).
    ``scan_segment_steps`` is rnad_tpu's TPU-watchdog workaround and changes
    nothing here."""
    del scan_segment_steps
    if eval_chunk_nodes is None:
        eval_chunk_nodes = nets.inference_chunk_nodes(net, tree.max_actions)
    data = dataset(tree)
    n_rows = data[0].shape[0]
    if node_batch is not None and batch_indices is None and generator is None:
        generator = torch.Generator(device=tree.device).manual_seed(0)
    params = list(net.parameters())
    opt = AdamState(mu=[torch.zeros_like(p) for p in params],
                    nu=[torch.zeros_like(p) for p in params])
    loss = torch.zeros(())
    for step in range(steps):
        if node_batch is None:
            batch = data
        else:
            idx = (batch_indices[step].to(tree.device)
                   if batch_indices is not None else
                   torch.randint(0, n_rows, (node_batch,),
                                 generator=generator, device=tree.device))
            batch = tuple(x[idx] for x in data)
        loss, _ = supervised_loss(net, *batch)
        grads = torch.autograd.grad(loss, params)
        adam_update(params, list(grads), opt, lr, B1, B2, EPS)

    if tree.size > eval_chunk_nodes:
        joint = nashconv_lib.joint_policy_from_net(tree, net,
                                                   eval_chunk_nodes)
        result = nashconv_lib.nashconv_root(tree, joint)
    else:
        joint = nashconv_lib.joint_policy_all_nodes(tree, net)
        result = nashconv_lib.nashconv_pure(tree, joint)
    return net, {"final_loss": float(loss.detach()),
                 "nashconv": float(result.nashconv())}
