"""Parallel-in-time two-player V-trace: the associative form.

Counterpart of ``rnad_tpu/learn/vtrace_assoc.py``.  ``vtrace.v_trace``
walks the trajectory backwards one half-step at a time; this module
computes the same recursion in O(log T) dependent steps.  The v-trace
carry is affine in itself but for the importance-sampling chain, which
enters through ``min(cs * IS, rho)``; the IS chain, though, is a segmented
product of behavior ratios that reads no other carry field.  So:

- round 1 evaluates four independent segmented affine recurrences, as one
  suffix scan over stacked (a, b) coefficients, where a half-step's map is
  C_t = a_t + b_t * C_{t+1} and segments reset at the player's own steps
  and at invalid steps: the IS product of the opponent's ratios since the
  player's next own step, the entropy-corrected reward accumulated over
  opponent steps, the ratio-weighted discounted reward chain, and the
  player's next critic value discounted through the gap;
- round 2, with ``min(cs * IS, rho)`` and ``min(cs * IS, c)`` now plain
  data, evaluates the v-target recursion as one more affine suffix scan.

Affine maps compose associatively, so both rounds reassociate the
sequential recursion exactly; the results differ from ``vtrace.v_trace``
by float rounding only.  As in rnad_tpu, the IS and opponent-reward chains
are clamped to +-1e15 once, at the end, where the sequential form clamps
them at every opponent step; the two can differ only where a chain had
already passed 1e15 mid-segment.

There is no TPU kernel here; the suffix scan is plain PyTorch: ceil(log2 T)
doubling rounds of elementwise products over the whole (T, ...) tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import vtrace

_IS_CAP = 1e15


def affine_suffix_scan(a: torch.Tensor, b: torch.Tensor, init
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_t = a_t + b_t * C_{t+1} for all t, with C_T = ``init`` (a scalar
    or a tensor broadcastable to one time slice), along axis 0 of the (T,
    ...) tensors ``a`` and ``b``, by doubling: after round k, (a_t, b_t)
    maps C_{t + 2^k} to C_t, composed as ``a_e + b_e * a_l``, ``b_e * b_l``
    with the later map (t + 2^k) inside.  Returns (C, C_next), C_next[t] =
    C[t + 1], the carry the sequential loop sees entering step t."""
    T = a.shape[0]
    d = 1
    while d < T:
        a = torch.cat([a[:-d] + b[:-d] * a[d:], a[-d:]], 0)
        b = torch.cat([b[:-d] * b[d:], b[-d:]], 0)
        d *= 2
    C = a + b * init
    last = torch.as_tensor(init, dtype=C.dtype, device=C.device)
    C_next = torch.cat([C[1:], last.expand(C[:1].shape)], 0)
    return C, C_next


def v_trace_assoc(v, valid, player_id, acting_policy, merged_policy,
                  merged_log_policy, p_others, actions_oh, reward,
                  player: int, *, eta: float, lambda_: float = 1.0,
                  c: float = 1.0, rho: float = 1.0, gamma: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``vtrace.v_trace`` (same arguments and outputs), parallel in time."""
    played = vtrace.has_played(valid, player_id, player)
    ratio = vtrace.policy_ratio(merged_policy, acting_policy, actions_oh,
                                valid)
    inv_mu = vtrace.policy_ratio(torch.ones_like(merged_policy),
                                 acting_policy, actions_oh, valid)
    ratio = torch.clamp(ratio, max=_IS_CAP)
    inv_mu = torch.clamp(inv_mu, max=_IS_CAP)

    ent = (-eta * (merged_policy * merged_log_policy).sum(-1)
           * p_others[..., 0])
    eta_log_policy = -eta * merged_log_policy * p_others

    mine = (player_id == player) & (valid > 0)
    opp = (player_id != player) & (valid > 0)
    v_sq = v[..., 0]  # (T, B)
    r = reward
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    g = torch.full_like(r, gamma)

    # round 1: the four chains that read no other (own and invalid steps
    # reset them: IS to 1, the rest to 0; NV takes v at own steps)
    a4 = torch.stack([
        torch.where(opp, zero, one),  # IS
        torch.where(opp, r + ent, zero),  # entropy-corrected reward
        torch.where(opp, ent + ratio * r, zero),  # discounted reward
        torch.where(mine, v_sq, zero),  # next value
    ], -1)
    b4 = torch.stack([
        torch.where(opp, ratio, zero),
        torch.where(opp, g, zero),
        torch.where(opp, ratio * gamma, zero),
        torch.where(opp, g, zero),
    ], -1)
    init4 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=a4.dtype,
                         device=a4.device)
    _, C4_next = affine_suffix_scan(a4, b4, init4)
    is_next = torch.clamp(C4_next[..., 0], max=_IS_CAP)
    ru_next = C4_next[..., 1]
    r_next = torch.clamp(C4_next[..., 2], -_IS_CAP, _IS_CAP)
    nv_next = C4_next[..., 3]

    ru_used = r + gamma * ru_next + ent
    dr_used = r + gamma * r_next
    rho_hat = torch.clamp(ratio * is_next, max=rho)
    c_hat = torch.clamp(ratio * is_next, max=c)

    # round 2: the v-target chain, affine at own steps, decaying by gamma
    # across opponent steps, reset to 0 at invalid ones
    a_vt = torch.where(
        mine,
        v_sq + rho_hat * (ru_used + gamma * nv_next - v_sq)
        - lambda_ * c_hat * gamma * nv_next,
        zero)
    b_vt = torch.where(mine, lambda_ * c_hat * gamma,
                       torch.where(opp, g, zero))
    nvt, nvt_next = affine_suffix_scan(a_vt, b_vt, 0.0)

    mine_f = mine.to(v.dtype)
    v_target = (nvt * mine_f)[..., None]
    learning_output = (
        v + eta_log_policy
        + actions_oh * inv_mu[..., None]
        * (dr_used[..., None]
           + gamma * is_next[..., None] * nvt_next[..., None]
           - v)) * mine_f[..., None]
    return v_target, played, learning_output


def v_trace_both_assoc(v, valid, player_id, acting_policy, merged_policy,
                       merged_log_policy, actions_oh, reward, *, eta: float,
                       lambda_: float = 1.0, c: float = 1.0,
                       rho: float = 1.0, gamma: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both players' associative v-trace stacked on a leading player axis
    (``vtrace.v_trace_both``'s contract); the column player's reward is
    negated."""
    outs = [v_trace_assoc(
        v, valid, player_id, acting_policy, merged_policy,
        merged_log_policy, vtrace.player_others(player_id, valid, p),
        actions_oh, sign * reward, p, eta=eta, lambda_=lambda_, c=c,
        rho=rho, gamma=gamma) for p, sign in ((0, 1.0), (1, -1.0))]
    return tuple(torch.stack(x) for x in zip(*outs))
