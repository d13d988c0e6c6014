"""Two-player V-trace with the R-NaD reward transform, plus the NeuRD and
critic losses, in the (T, B, A) layout and in the batch-minor (T, A, B)
layout of ``learner_layout="amb"``.

Counterpart of ``rnad_tpu/learn/vtrace.py``.
The JAX reverse ``lax.scan`` is a Python loop over T here, and the vmap
over the two players is a written-out leading player axis of size 2.
Semantics, clamps and tie rules follow the counterpart line by line:

  * reward transform ``-eta * sum(pi * log(pi/pi_reg))`` into the reward and
    ``-eta * log(pi/pi_reg)`` into the Q target, signed +1 for the acting
    player and -1 for the opponent;
  * the 5-field carry and its player/opponent/reset selection;
  * IS ratios clipped at rho_bar and c_bar, with the 1e15 f32 overflow caps;
  * policy post-processing by epsilon-threshold and greedy discretization;
  * NeuRD loss with advantage clipping and the logit-threshold gate, and
    the masked-MSE critic loss.

The v-trace block is gradient-free (the learner differentiates only the
losses), so ``v_trace``/``v_trace_both`` expect detached inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_IS_CAP = 1e15


def player_others(player_ids: torch.Tensor, valid: torch.Tensor,
                  player: int) -> torch.Tensor:
    """+1 for the acting player's steps, -1 for others, 0 on invalid steps;
    trailing singleton dim."""
    res = (2 * (player_ids == player).to(valid.dtype) - 1) * valid
    return res[..., None].to(torch.float32)


def has_played(valid: torch.Tensor, player_id: torch.Tensor,
               player: int) -> torch.Tensor:
    """Mask of the player's own valid steps (the closed form of the
    reference's dead-carry scan)."""
    return ((valid > 0) & (player_id == player)).to(player_id.dtype)


def policy_ratio(pi: torch.Tensor, mu: torch.Tensor,
                 actions_oh: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """pi/mu of the chosen action; 1 on invalid steps; the denominator is
    floored at 1e-30."""
    prob = lambda p: (actions_oh * p).sum(-1) * valid + (1 - valid)
    return prob(pi) / torch.clamp(prob(mu), min=1e-30)


def _v_trace_players(v, valid, player_id, acting_policy, merged_policy,
                     merged_log_policy, p_others, actions_oh, reward,
                     players, *, eta, lambda_, c, rho, gamma):
    """V-trace for a leading player axis P: ``p_others`` (P, T, B, 1),
    ``reward`` (P, T, B), ``players`` a list of P player ids; every other
    input is shared.  Returns (v_target (P,T,B,1), learning_output
    (P,T,B,A))."""
    T = valid.shape[0]
    P = len(players)
    ratio = policy_ratio(merged_policy, acting_policy, actions_oh, valid)
    inv_mu = policy_ratio(torch.ones_like(merged_policy), acting_policy,
                          actions_oh, valid)
    inv_mu = torch.clamp(inv_mu, max=_IS_CAP)
    ratio = torch.clamp(ratio, max=_IS_CAP)

    eta_reg_entropy = (-eta
                       * (merged_policy * merged_log_policy).sum(-1)
                       * p_others[..., 0])  # (P, T, B)
    eta_log_policy = -eta * merged_log_policy * p_others  # (P, T, B, A)
    mine = torch.stack([player_id == p for p in players])  # (P, T, B)

    B = valid.shape[1]
    zeros_b = v.new_zeros((P, B))
    zeros_b1 = v.new_zeros((P, B, 1))
    ones_b = v.new_ones((P, B))
    c_reward, c_unc, c_next_v, c_next_vt, c_is = (
        zeros_b, zeros_b, zeros_b1, zeros_b1, ones_b)
    v_targets = [None] * T
    outputs = [None] * T
    for t in reversed(range(T)):
        cs, v_t, r_t, ent_t = ratio[t], v[t], reward[:, t], eta_reg_entropy[:, t]
        valid_t, mine_t = valid[t] > 0, mine[:, t]
        inv_mu_t, aoh_t, elp_t = inv_mu[t], actions_oh[t], eta_log_policy[:, t]

        reward_uncorrected = r_t + gamma * c_unc + ent_t
        discounted_reward = r_t + gamma * c_reward

        our_v_target = (
            v_t
            + torch.clamp(cs * c_is, max=rho)[..., None]
            * (reward_uncorrected[..., None] + gamma * c_next_v - v_t)
            + lambda_
            * torch.clamp(cs * c_is, max=c)[..., None]
            * gamma * (c_next_vt - c_next_v))

        our_learning_output = (
            v_t + elp_t
            + aoh_t * inv_mu_t[..., None]
            * (discounted_reward[..., None]
               + gamma * c_is[..., None] * c_next_vt
               - v_t))

        opp_reward = torch.clamp(ent_t + cs * discounted_reward,
                                 -_IS_CAP, _IS_CAP)
        opp_is = torch.clamp(cs * c_is, max=_IS_CAP)

        # carry: valid & mine -> ours, valid & ~mine -> opponent's, else init
        m1 = mine_t & valid_t
        o1 = ~mine_t & valid_t
        m2, o2 = m1[..., None], o1[..., None]
        c_reward = torch.where(o1, opp_reward, zeros_b)
        c_unc = torch.where(o1, reward_uncorrected, zeros_b)
        v_t_b = v_t.expand(P, B, 1)
        c_next_v = torch.where(m2, v_t_b,
                               torch.where(o2, gamma * c_next_v, zeros_b1))
        c_next_vt = torch.where(m2, our_v_target,
                                torch.where(o2, gamma * c_next_vt, zeros_b1))
        c_is = torch.where(o1, opp_is, ones_b)

        v_targets[t] = torch.where(m2, our_v_target,
                                   torch.zeros_like(our_v_target))
        outputs[t] = torch.where(m2, our_learning_output,
                                 torch.zeros_like(our_learning_output))
    return torch.stack(v_targets, 1), torch.stack(outputs, 1)


def v_trace(v, valid, player_id, acting_policy, merged_policy,
            merged_log_policy, p_others, actions_oh, reward, player: int, *,
            eta: float, lambda_: float = 1.0, c: float = 1.0,
            rho: float = 1.0, gamma: float = 1.0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """V-trace over mixed-player trajectories for one player.  Shapes:
    v (T,B,1), valid/player_id/reward (T,B), policies and actions_oh
    (T,B,A), p_others (T,B,1).  Returns (v_target (T,B,1), has_played
    (T,B), learning_output (T,B,A))."""
    v_t, out = _v_trace_players(
        v, valid, player_id, acting_policy, merged_policy, merged_log_policy,
        p_others[None], actions_oh, reward[None], [player], eta=eta,
        lambda_=lambda_, c=c, rho=rho, gamma=gamma)
    return v_t[0], has_played(valid, player_id, player), out[0]


def v_trace_both(v, valid, player_id, acting_policy, merged_policy,
                 merged_log_policy, actions_oh, reward, *, eta: float,
                 lambda_: float = 1.0, c: float = 1.0, rho: float = 1.0,
                 gamma: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both players' v-trace in one loop over T, on a leading player axis;
    the column player's reward is negated.  Outputs are stacked (2, ...)."""
    rewards2 = torch.stack([reward, -reward])
    p_others2 = torch.stack([player_others(player_id, valid, 0),
                             player_others(player_id, valid, 1)])
    v_t, out = _v_trace_players(
        v, valid, player_id, acting_policy, merged_policy, merged_log_policy,
        p_others2, actions_oh, rewards2, [0, 1], eta=eta, lambda_=lambda_,
        c=c, rho=rho, gamma=gamma)
    played = torch.stack([has_played(valid, player_id, 0),
                          has_played(valid, player_id, 1)])
    return v_t, played, out


def process_policy(policy: torch.Tensor, mask: torch.Tensor, n_disc: int,
                   epsilon_threshold: float = 0.03) -> torch.Tensor:
    """Epsilon-threshold + grid discretization of the learner policy.

    Probabilities below the threshold are zeroed (unless all are below it),
    the rest renormalized, then each is rounded up to blocks of 1/n_disc and
    blocks are granted greedily in descending-probability order (ties by
    index) until n_disc blocks are spent."""
    keep = mask * ((policy >= epsilon_threshold).to(policy.dtype)
                   + (policy.amax(-1, keepdim=True)
                      < epsilon_threshold).to(policy.dtype))
    keep = torch.clamp(keep, max=1.0)
    p = keep * policy
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)

    blocks = torch.ceil(n_disc * p)
    # exclusive prefix sum in sorted order as a pairwise rank:
    # j sorts before i iff p_j > p_i, or p_j == p_i and j < i
    n_actions = p.shape[-1]
    ps = [p[..., i] for i in range(n_actions)]
    bs = [blocks[..., i] for i in range(n_actions)]
    granted = []
    for i in range(n_actions):
        excl = torch.zeros_like(ps[i])
        for j in range(n_actions):
            if j == i:
                continue
            before = (ps[j] > ps[i]) if j > i else (ps[j] >= ps[i])
            excl = excl + bs[j] * before
        granted.append(torch.minimum(torch.clamp(n_disc - excl, min=0.0),
                                     bs[i]))
    result = torch.stack(granted, dim=-1)
    return result / n_disc


def apply_force_with_threshold(decision_outputs: torch.Tensor,
                               force: torch.Tensor, threshold: float,
                               threshold_center: torch.Tensor
                               ) -> torch.Tensor:
    """NeuRD gradient gate: forces apply only while the logit stays inside
    [-threshold, threshold] in the force's direction."""
    can_decrease = decision_outputs - threshold_center > -threshold
    can_increase = decision_outputs - threshold_center < threshold
    force_negative = torch.clamp(force, max=0.0)
    force_positive = torch.clamp(force, min=0.0)
    clipped = can_decrease * force_negative + can_increase * force_positive
    return decision_outputs * clipped.detach()


def renormalize(loss: torch.Tensor, mask: torch.Tensor,
                global_sum=None) -> torch.Tensor:
    """Masked mean.  Under ``global_sum`` (``DataGroup.global_sum``, when
    the batch is a rank's slice of the lanes) it is this rank's numerator
    over the global valid count: the count is summed over the ranks and
    carries no gradient, so the ranks' losses add up to the global mean
    and so do their gradients (``learn_step`` sums them)."""
    loss = (loss * mask).sum()
    n = mask.sum()
    if global_sum is not None:
        n = global_sum(n)
    return loss / (n + (n == 0.0))


def get_loss_v(v_list: Sequence[torch.Tensor],
               v_target_list: Sequence[torch.Tensor],
               mask_list: Sequence[torch.Tensor],
               global_sum=None) -> torch.Tensor:
    """Masked MSE critic loss against detached targets; ``global_sum`` as
    in ``renormalize``."""
    total = 0.0
    for v_n, v_target, mask in zip(v_list, v_target_list, mask_list):
        err = mask[..., None] * (v_n - v_target.detach()) ** 2
        err, n = err.sum(), mask.sum()
        if global_sum is not None:
            n = global_sum(n)
        total = total + err / (n + (n == 0.0))
    return total


def get_loss_nerd(logit_list: Sequence[torch.Tensor],
                  policy_list: Sequence[torch.Tensor],
                  q_vr_list: Sequence[torch.Tensor],
                  valid: torch.Tensor, player_ids: torch.Tensor,
                  legal_actions: torch.Tensor,
                  importance_sampling_correction: Sequence[torch.Tensor],
                  clip: float = 100.0, threshold: float = 2.0,
                  global_sum=None) -> torch.Tensor:
    """NeuRD policy loss.  The logit centering is a mean over ALL A entries
    of ``logit * legal``, as in the reference; ``global_sum`` as in
    ``renormalize``."""
    total = 0.0
    for k, (logit_pi, pi, q_vr, is_c) in enumerate(
            zip(logit_list, policy_list, q_vr_list,
                importance_sampling_correction)):
        adv_pi = q_vr - (pi * q_vr).sum(-1, keepdim=True)
        adv_pi = is_c * adv_pi
        adv_pi = torch.clamp(adv_pi, -clip, clip).detach()

        logits = logit_pi - (logit_pi * legal_actions).mean(-1, keepdim=True)
        nerd = (legal_actions
                * apply_force_with_threshold(
                    logits, adv_pi, threshold,
                    torch.zeros_like(logits))).sum(-1)
        total = total - renormalize(nerd, valid * (player_ids == k),
                                    global_sum)
    return total


# ---------------------------------------------------------------------------
# The batch-minor layout (``learner_layout="amb"``)
#
# The same computations with every (T, B, A) tensor as (T, A, B) and every
# (T, B, 1) value column as (T, B): the same elementwise operations in the
# same order and the same reductions over A, so each result is bitwise the
# (T, B, A) function's after the permute (tests/test_torch_vtrace_minor.py).
# ---------------------------------------------------------------------------


def policy_ratio_minor(pi: torch.Tensor, mu: torch.Tensor,
                       actions_oh: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """``policy_ratio`` for (T, A, B) policies; returns (T, B)."""
    prob = lambda p: (actions_oh * p).sum(-2) * valid + (1 - valid)
    return prob(pi) / torch.clamp(prob(mu), min=1e-30)


def _v_trace_players_minor(v, valid, player_id, acting_policy,
                           merged_policy, merged_log_policy, p_others,
                           actions_oh, reward, players, *, eta, lambda_, c,
                           rho, gamma):
    """``_v_trace_players`` in the batch-minor layout: ``v`` (T, B),
    ``p_others`` and ``reward`` (P, T, B), the policies and ``actions_oh``
    (T, A, B).  Returns (v_target (P, T, B), learning_output (P, T, A,
    B))."""
    T = valid.shape[0]
    P = len(players)
    ratio = policy_ratio_minor(merged_policy, acting_policy, actions_oh,
                               valid)
    inv_mu = policy_ratio_minor(torch.ones_like(merged_policy),
                                acting_policy, actions_oh, valid)
    inv_mu = torch.clamp(inv_mu, max=_IS_CAP)
    ratio = torch.clamp(ratio, max=_IS_CAP)

    eta_reg_entropy = (-eta
                       * (merged_policy * merged_log_policy).sum(-2)
                       * p_others)  # (P, T, B)
    eta_log_policy = (-eta * merged_log_policy
                      * p_others[:, :, None, :])  # (P, T, A, B)
    mine = torch.stack([player_id == p for p in players])  # (P, T, B)

    B = valid.shape[1]
    zeros_b = v.new_zeros((P, B))
    ones_b = v.new_ones((P, B))
    c_reward, c_unc, c_next_v, c_next_vt, c_is = (
        zeros_b, zeros_b, zeros_b, zeros_b, ones_b)
    v_targets = [None] * T
    outputs = [None] * T
    for t in reversed(range(T)):
        cs, v_t, r_t, ent_t = ratio[t], v[t], reward[:, t], eta_reg_entropy[:, t]
        valid_t, mine_t = valid[t] > 0, mine[:, t]
        inv_mu_t, aoh_t, elp_t = inv_mu[t], actions_oh[t], eta_log_policy[:, t]

        reward_uncorrected = r_t + gamma * c_unc + ent_t
        discounted_reward = r_t + gamma * c_reward

        our_v_target = (
            v_t
            + torch.clamp(cs * c_is, max=rho)
            * (reward_uncorrected + gamma * c_next_v - v_t)
            + lambda_
            * torch.clamp(cs * c_is, max=c)
            * gamma * (c_next_vt - c_next_v))

        our_learning_output = (
            v_t + elp_t
            + aoh_t * inv_mu_t
            * (discounted_reward[:, None, :]
               + (gamma * c_is * c_next_vt)[:, None, :]
               - v_t))

        opp_reward = torch.clamp(ent_t + cs * discounted_reward,
                                 -_IS_CAP, _IS_CAP)
        opp_is = torch.clamp(cs * c_is, max=_IS_CAP)

        m1 = mine_t & valid_t
        o1 = ~mine_t & valid_t
        c_reward = torch.where(o1, opp_reward, zeros_b)
        c_unc = torch.where(o1, reward_uncorrected, zeros_b)
        v_t_b = v_t.expand(P, B)
        c_next_v = torch.where(m1, v_t_b,
                               torch.where(o1, gamma * c_next_v, zeros_b))
        c_next_vt = torch.where(m1, our_v_target,
                                torch.where(o1, gamma * c_next_vt, zeros_b))
        c_is = torch.where(o1, opp_is, ones_b)

        v_targets[t] = torch.where(m1, our_v_target,
                                   torch.zeros_like(our_v_target))
        outputs[t] = torch.where(m1[:, None, :], our_learning_output,
                                 torch.zeros_like(our_learning_output))
    return torch.stack(v_targets, 1), torch.stack(outputs, 1)


def v_trace_minor(v, valid, player_id, acting_policy, merged_policy,
                  merged_log_policy, p_others, actions_oh, reward,
                  player: int, *, eta: float, lambda_: float = 1.0,
                  c: float = 1.0, rho: float = 1.0, gamma: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``v_trace`` in the batch-minor layout: v, ``p_others`` (without its
    trailing 1), valid, player_id and reward (T, B), the policies and
    actions_oh (T, A, B).  Returns (v_target (T, B), has_played (T, B),
    learning_output (T, A, B))."""
    v_t, out = _v_trace_players_minor(
        v, valid, player_id, acting_policy, merged_policy, merged_log_policy,
        p_others[None], actions_oh, reward[None], [player], eta=eta,
        lambda_=lambda_, c=c, rho=rho, gamma=gamma)
    return v_t[0], has_played(valid, player_id, player), out[0]


def v_trace_both_minor(v, valid, player_id, acting_policy, merged_policy,
                       merged_log_policy, actions_oh, reward, *, eta: float,
                       lambda_: float = 1.0, c: float = 1.0,
                       rho: float = 1.0, gamma: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``v_trace_both`` in the batch-minor layout; outputs stacked (2,
    ...)."""
    rewards2 = torch.stack([reward, -reward])
    p_others2 = torch.stack([player_others(player_id, valid, 0)[..., 0],
                             player_others(player_id, valid, 1)[..., 0]])
    v_t, out = _v_trace_players_minor(
        v, valid, player_id, acting_policy, merged_policy, merged_log_policy,
        p_others2, actions_oh, rewards2, [0, 1], eta=eta, lambda_=lambda_,
        c=c, rho=rho, gamma=gamma)
    played = torch.stack([has_played(valid, player_id, 0),
                          has_played(valid, player_id, 1)])
    return v_t, played, out


def process_policy_minor(policy: torch.Tensor, mask: torch.Tensor,
                         n_disc: int, epsilon_threshold: float = 0.03
                         ) -> torch.Tensor:
    """``process_policy`` for (..., A, B) policies (action axis -2); the
    branchless pairwise discretizer covers A <= 16, as ``rnad_tpu``'s."""
    n_actions = policy.shape[-2]
    if n_actions > 16:
        raise NotImplementedError(
            "process_policy_minor covers the branchless pairwise form only "
            "(A <= 16); use the (T, B, A) path for wider action spaces")
    keep = mask * ((policy >= epsilon_threshold).to(policy.dtype)
                   + (policy.amax(-2, keepdim=True)
                      < epsilon_threshold).to(policy.dtype))
    keep = torch.clamp(keep, max=1.0)
    p = keep * policy
    p = p / torch.clamp(p.sum(-2, keepdim=True), min=1e-30)

    blocks = torch.ceil(n_disc * p)
    ps = [p[..., i, :] for i in range(n_actions)]
    bs = [blocks[..., i, :] for i in range(n_actions)]
    granted = []
    for i in range(n_actions):
        excl = torch.zeros_like(ps[i])
        for j in range(n_actions):
            if j == i:
                continue
            before = (ps[j] > ps[i]) if j > i else (ps[j] >= ps[i])
            excl = excl + bs[j] * before
        granted.append(torch.minimum(torch.clamp(n_disc - excl, min=0.0),
                                     bs[i]))
    return torch.stack(granted, dim=-2) / n_disc


def get_loss_v_minor(v_list: Sequence[torch.Tensor],
                     v_target_list: Sequence[torch.Tensor],
                     mask_list: Sequence[torch.Tensor],
                     global_sum=None) -> torch.Tensor:
    """``get_loss_v`` with (T, B) values (no trailing singleton)."""
    total = 0.0
    for v_n, v_target, mask in zip(v_list, v_target_list, mask_list):
        err = mask * (v_n - v_target.detach()) ** 2
        err, n = err.sum(), mask.sum()
        if global_sum is not None:
            n = global_sum(n)
        total = total + err / (n + (n == 0.0))
    return total


def get_loss_nerd_minor(logit_list: Sequence[torch.Tensor],
                        policy_list: Sequence[torch.Tensor],
                        q_vr_list: Sequence[torch.Tensor],
                        valid: torch.Tensor, player_ids: torch.Tensor,
                        legal_actions: torch.Tensor,
                        importance_sampling_correction: Sequence[torch.Tensor],
                        clip: float = 100.0, threshold: float = 2.0,
                        global_sum=None) -> torch.Tensor:
    """``get_loss_nerd`` for (T, A, B) logits, policies and targets; the
    importance-sampling corrections are (T, B)."""
    total = 0.0
    for k, (logit_pi, pi, q_vr, is_c) in enumerate(
            zip(logit_list, policy_list, q_vr_list,
                importance_sampling_correction)):
        adv_pi = q_vr - (pi * q_vr).sum(-2, keepdim=True)
        adv_pi = is_c[:, None, :] * adv_pi
        adv_pi = torch.clamp(adv_pi, -clip, clip).detach()

        logits = logit_pi - (logit_pi * legal_actions).mean(-2, keepdim=True)
        nerd = (legal_actions
                * apply_force_with_threshold(
                    logits, adv_pi, threshold,
                    torch.zeros_like(logits))).sum(-2)
        total = total - renormalize(nerd, valid * (player_ids == k),
                                    global_sum)
    return total
