"""Masked policy math.

Counterpart of ``rnad_tpu/models/common.py``.  Illegal logits are set to
-1e30 (not -inf, so no NaN can appear), the policy is the softmax over legal
actions and exactly 0 on illegal ones, and the log-policy is exactly 0 on
illegal actions (the reference stores 0, not -inf, there).  The
``*_minor`` forms take the batch-minor (..., A, B) layout of
``learner_layout="amb"``.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_logits(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Sets illegal-action logits to a large negative value."""
    return torch.where(legal > 0, logits, torch.full_like(logits, _NEG_INF))


def masked_policy(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over legal actions; zero on illegal actions."""
    p = torch.softmax(masked_logits(logits, legal), dim=-1)
    return torch.where(legal > 0, p, torch.zeros_like(p))


def masked_log_policy(logits: torch.Tensor, legal: torch.Tensor
                      ) -> torch.Tensor:
    """log softmax over legal actions; exactly 0 on illegal actions."""
    lp = torch.log_softmax(masked_logits(logits, legal), dim=-1)
    return torch.where(legal > 0, lp, torch.zeros_like(lp))


def masked_policy_minor(logits: torch.Tensor, legal: torch.Tensor
                        ) -> torch.Tensor:
    """``masked_policy`` for batch-minor (..., A, B) tensors (action axis
    -2; learn/vtrace.py's batch-minor section).  The softmax runs on the
    (..., B, A) view of them: torch's softmax over an inner dimension
    rounds differently from its softmax over the last, and the two layouts
    must agree bitwise."""
    t = lambda x: x.transpose(-1, -2)
    return t(masked_policy(t(logits), t(legal)))


def masked_log_policy_minor(logits: torch.Tensor, legal: torch.Tensor
                            ) -> torch.Tensor:
    """``masked_log_policy`` for batch-minor (..., A, B) tensors."""
    lp = torch.log_softmax(masked_logits(logits, legal), dim=-2)
    return torch.where(legal > 0, lp, torch.zeros_like(lp))
