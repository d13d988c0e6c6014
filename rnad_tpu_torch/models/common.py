"""Masked policy math.

Counterpart of ``rnad_tpu/models/common.py``.  Illegal logits are set to
-1e30 (not -inf, so no NaN can appear), the policy is the softmax over legal
actions and exactly 0 on illegal ones, and the log-policy is exactly 0 on
illegal actions (the reference stores 0, not -inf, there).
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
