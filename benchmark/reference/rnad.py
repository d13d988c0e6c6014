"""The plain R-NaD train step: rollout, v-trace, the NeuRD and critic
losses, clip + Adam, EMA.

A rewrite in plain PyTorch, patterned on ``rnad_tpu/learn/rnad.py``,
``learn/vtrace.py``, ``env/engine.py`` and ``models/common.py``; it imports
nothing of the program.  The game is the tree's arrays.  A rollout plays
``max_depth`` turns from the root on B lanes: both seats see their
observation of the state ([expected value | legal] for the row seat, its
negated transpose for the column seat), act by Gumbel-max over their legal
logits, and the joint cell's chance outcome is the Gumbel-max of its log
chance.  The noise is drawn from one generator in the program's documented
order (each turn ``g_act`` (2B, A), then ``g_chance`` drawn as (T, B)), so
the same seed plays the same episodes.

Where the configuration lifts its observations, each seat's raw (2, A, A)
observation becomes ``[lifted_0, legal, lifted_1, ..., lifted_{C-1}]`` with
``lifted[c] = sum_d mix[c, d] raw[d] + bias[c] + sigma eps[c]``: ``mix``
and ``bias`` are the seeded data both sides are handed, and the unit
Gaussian ``eps`` (2B, C, A, A) is drawn each turn after ``g_act`` and
``g_chance``, the program's documented order under a lift.

A net's state that is not trained (a ConvNet's BatchNorm running averages)
is carried beside each net's weights: the learner's pass runs in train
mode over the valid half-steps (its mask) and moves the learner's state;
every rollout turn and the three frozen passes read their net's state; the
EMA target averages the learner's state after Adam as it averages the
weights; the regularization pair keep theirs, since no update boundary
falls inside a run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import nets

NEG = -1e30
TINY = torch.finfo(torch.float32).tiny


class Game:
    """The tree's arrays on a device, and the lift of the observations:
    ``lift`` holds its ``mix`` and ``bias``, ``sigma`` its noise's scale
    (module docstring); without it the observations are raw."""

    def __init__(self, arrays: Dict[str, np.ndarray], device,
                 lift: Optional[Dict[str, torch.Tensor]] = None,
                 sigma: float = 0.0):
        t = lambda k: torch.as_tensor(arrays[k]).to(device)
        self.lift = (None if lift is None
                     else {k: v.to(device).float() for k, v in lift.items()})
        self.sigma = sigma
        self.ev = t("expected_value")[:, 0]  # (S, A, A)
        self.legal = t("legal")[:, 0]
        self.chance = t("chance")  # (S, T, A, A)
        self.index = t("index").long()
        self.value = t("value")
        self.max_depth = int(arrays["depth"][1])
        self.A = self.ev.shape[-1]
        self.T = self.chance.shape[1]

    def observe(self, idx: torch.Tensor, eps: Optional[torch.Tensor] = None):
        """Both seats' observations (2B, C, A, A) and legal actions (2B,
        A) at states ``idx`` (B,): raw (C = 2), or lifted with the noise
        ``eps`` (2B, C - 1, A, A)."""
        ev, lg = self.ev[idx], self.legal[idx]
        row = torch.stack([ev, lg], 1)
        col = torch.stack([-ev, lg], 1).transpose(2, 3)
        masks = torch.cat([lg[:, :, 0], lg[:, 0, :]])
        raw = torch.cat([row, col])
        if self.lift is None:
            return raw, masks
        lifted = (torch.einsum("cd,ndij->ncij", self.lift["mix"], raw)
                  + self.lift["bias"] + self.sigma * eps)
        return torch.cat([lifted[:, :1], raw[:, 1:2], lifted[:, 1:]],
                         1), masks


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device,
                   dtype=torch.float32).clamp_(min=TINY)
    return -torch.log(-torch.log(u))


def masked_logits(logits, legal):
    return torch.where(legal > 0, logits, torch.full_like(logits, NEG))


def policy(logits, legal):
    p = torch.softmax(masked_logits(logits, legal), -1)
    return torch.where(legal > 0, p, torch.zeros_like(p))


def log_policy(logits, legal):
    lp = torch.log_softmax(masked_logits(logits, legal), -1)
    return torch.where(legal > 0, lp, torch.zeros_like(lp))


@torch.no_grad()
def rollout(game: Game, forward, lanes: int, gen: torch.Generator,
            device) -> Dict[str, torch.Tensor]:
    """One batch of episodes: (2 turns, B) records of the states, the
    mover's policy, action, reward (row seat's) and value, and the
    observations."""
    A, T, B = game.A, game.T, lanes
    idx = torch.ones((B,), dtype=torch.long, device=device)
    rec = {k: [] for k in ("indices", "policy", "actions", "rewards",
                           "values", "obs")}
    C = None if game.lift is None else game.lift["mix"].shape[0]
    for _ in range(game.max_depth):
        g_act = gumbel((2 * B, A), gen, device)
        g_ch = gumbel((T, B), gen, device).t()
        eps = (None if C is None else torch.randn(
            (2 * B, C, A, A), generator=gen, device=device))
        obs, legal = game.observe(idx, eps)
        logits, values = forward(obs)
        act = torch.argmax(masked_logits(logits, legal) + g_act, 1)
        ra, ca = act[:B], act[B:]
        ch = game.chance[idx, :, ra, ca]  # (B, T)
        log_ch = torch.where(ch > 0, torch.log(torch.clamp(ch, min=1e-30)),
                             torch.full_like(ch, NEG))
        k = torch.argmax(log_ch + g_ch, 1)
        new = game.index[idx, k, ra, ca]
        val = game.value[idx, k, ra, ca]
        reward = torch.where(new == 0, val, torch.zeros_like(val))
        rec["indices"].append(torch.stack([idx, idx]))
        rec["policy"].append(policy(logits, legal).reshape(2, B, A))
        rec["actions"].append(act.reshape(2, B))
        rec["rewards"].append(torch.stack([torch.zeros_like(reward),
                                           reward]))
        rec["values"].append(values.reshape(2, B))
        rec["obs"].append(obs.reshape((2, B) + obs.shape[1:]))
        idx = new
    return {k: torch.cat(v) for k, v in rec.items()}


# ---------------------------------------------------------------------------
# v-trace and the losses
# ---------------------------------------------------------------------------


def process_policy(pi, mask, n_disc: int, eps: float):
    """Probabilities under ``eps`` are dropped (unless all are), the rest
    renormalized, rounded up to blocks of 1 / n_disc, and the blocks
    granted in descending order of probability (ties to the lower index)
    until n_disc are spent."""
    keep = mask * torch.clamp((pi >= eps).float()
                              + (pi.amax(-1, keepdim=True) < eps).float(),
                              max=1.0)
    p = keep * pi
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    blocks = torch.ceil(n_disc * p)
    order = torch.sort(-p, dim=-1, stable=True).indices
    b_sorted = blocks.gather(-1, order)
    before = torch.cumsum(b_sorted, -1) - b_sorted
    granted = torch.minimum(torch.clamp(n_disc - before, min=0.0), b_sorted)
    return torch.zeros_like(p).scatter(-1, order, granted) / n_disc


def v_trace(v, valid, player_id, mu, pi, log_pi, actions_oh, reward,
            player: int, eta: float, rho: float, c: float, gamma: float):
    """One player's v-trace over mixed-player trajectories with the
    regularized reward transform; returns (v_target (T, B, 1),
    learning_output (T, B, A))."""
    Tn, B = valid.shape
    sign = ((2 * (player_id == player).float() - 1) * valid)[..., None]
    prob = lambda p: (actions_oh * p).sum(-1) * valid + (1 - valid)
    ratio = torch.clamp(prob(pi) / torch.clamp(prob(mu), min=1e-30),
                        max=1e15)
    inv_mu = torch.clamp(1.0 / torch.clamp(prob(mu), min=1e-30), max=1e15)
    entropy = -eta * (pi * log_pi).sum(-1) * sign[..., 0]
    eta_log = -eta * log_pi * sign
    mine = player_id == player
    z = v.new_zeros((B,))
    z1 = v.new_zeros((B, 1))
    c_reward, c_unc, c_next_v, c_next_vt, c_is = z, z, z1, z1, v.new_ones(
        (B,))
    targets, outputs = [None] * Tn, [None] * Tn
    for t in reversed(range(Tn)):
        cs, v_t, r_t = ratio[t], v[t], reward[t]
        ok, me = valid[t] > 0, mine[t]
        r_unc = r_t + gamma * c_unc + entropy[t]
        r_disc = r_t + gamma * c_reward
        target = (v_t + torch.clamp(cs * c_is, max=rho)[:, None]
                  * (r_unc[:, None] + gamma * c_next_v - v_t)
                  + torch.clamp(cs * c_is, max=c)[:, None] * gamma
                  * (c_next_vt - c_next_v))
        out = (v_t + eta_log[t] + actions_oh[t] * inv_mu[t][:, None]
               * (r_disc[:, None] + gamma * c_is[:, None] * c_next_vt
                  - v_t))
        opp_reward = torch.clamp(entropy[t] + cs * r_disc, -1e15, 1e15)
        opp_is = torch.clamp(cs * c_is, max=1e15)
        m1, o1 = me & ok, ~me & ok
        m2, o2 = m1[:, None], o1[:, None]
        c_reward = torch.where(o1, opp_reward, z)
        c_unc = torch.where(o1, r_unc, z)
        c_next_v = torch.where(m2, v_t, torch.where(o2, gamma * c_next_v,
                                                    z1))
        c_next_vt = torch.where(m2, target,
                                torch.where(o2, gamma * c_next_vt, z1))
        c_is = torch.where(o1, opp_is, torch.ones_like(c_is))
        targets[t] = torch.where(m2, target, torch.zeros_like(target))
        outputs[t] = torch.where(m2, out, torch.zeros_like(out))
    return torch.stack(targets), torch.stack(outputs)


def masked_mean(x, mask):
    n = mask.sum()
    return (x * mask).sum() / (n + (n == 0.0))


def neurd(logits, pi, q, mask_legal, mask, clip: float, threshold: float):
    """The NeuRD term: centered logits pushed along the clipped advantage
    while they stay inside [-threshold, threshold] in its direction."""
    adv = torch.clamp(q - (pi * q).sum(-1, keepdim=True), -clip,
                      clip).detach()
    centered = logits - (logits * mask_legal).mean(-1, keepdim=True)
    gate = ((centered > -threshold) * torch.clamp(adv, max=0.0)
            + (centered < threshold) * torch.clamp(adv, min=0.0))
    return masked_mean((mask_legal * centered * gate.detach()).sum(-1), mask)


def learner_loss(params, frozen, traj, game: Game, net: dict, cfg: dict,
                 alpha: float, neurd_scale: float, prec: nets.Precision,
                 solver=None, state=None):
    """The loss of one update and its parts (loss_v, loss_nerd).  The
    learner's pass runs in train mode over the valid half-steps and moves
    its ``state``; ``frozen`` is the (weights, state) of the target and
    the regularization pair, read in eval mode."""
    forward = nets.family(net).forward
    Tn, B = traj["indices"].shape
    A = game.A
    obs = traj["obs"].reshape((Tn * B,) + traj["obs"].shape[2:])
    masks = traj["obs"][:, :, 1, :, 0].float()
    valid = (traj["indices"] != 0).float()
    player_id = (torch.arange(Tn, device=valid.device) % 2)[:, None].expand(
        Tn, B)
    feats = nets.features(net, obs, solver)
    logits, v = forward(params, obs, net, prec, feats, state=state,
                        train=True, mask=valid.reshape(-1))
    logits = logits.reshape(Tn, B, A)
    v = v.reshape(Tn, B, 1)
    pi = policy(logits, masks)
    log_pi = log_policy(logits, masks)
    a32 = np.float32(alpha)
    alpha_, beta = float(a32), float(np.float32(1) - a32)
    with torch.no_grad():
        target, reg, reg_prev = (forward(p, obs, net, prec, feats,
                                         state=st) for p, st in frozen)
        v_target = target[1].reshape(Tn, B, 1)
        lp_reg = log_policy(reg[0].reshape(Tn, B, A), masks)
        lp_reg_prev = log_policy(reg_prev[0].reshape(Tn, B, A), masks)
        pi_proc = process_policy(pi.detach(), masks, cfg["n_discrete"],
                                 cfg["epsilon_threshold"])
        lp_merged = log_pi.detach() - (alpha_ * lp_reg + beta * lp_reg_prev)
        actions_oh = torch.nn.functional.one_hot(
            traj["actions"].long(), A).float()
        outs = [v_trace(v_target, valid, player_id, traj["policy"], pi_proc,
                        lp_merged, actions_oh, sign * traj["rewards"], k,
                        cfg["eta"], cfg["roh_bar"], cfg["c_bar"],
                        cfg["vtrace_gamma"])
                for k, sign in ((0, 1.0), (1, -1.0))]
    loss_v = sum(masked_mean((v - vt) ** 2,
                             ((valid > 0) & (player_id == k)).float()[
                                 ..., None])
                 for k, (vt, _) in enumerate(outs))
    loss_nerd = -sum(neurd(logits, pi_proc, q, masks,
                           valid * (player_id == k), cfg["neurd_clip"],
                           cfg["logit_clip"])
                     for k, (_, q) in enumerate(outs))
    loss = (cfg["value_loss_weight"] * loss_v
            + neurd_scale * cfg["neurd_loss_weight"] * loss_nerd)
    return loss, loss_v, loss_nerd


# ---------------------------------------------------------------------------
# The optimizer and the three-step run
# ---------------------------------------------------------------------------


def learning_rate(cfg: dict, count: int) -> float:
    """Constant, or optax's ``cosine_decay_schedule(lr, lr_decay_steps,
    alpha=lr_final_fraction)``, in float32 as optax computes it."""
    if cfg["lr_schedule"] == "constant":
        return cfg["lr"]
    f32 = np.float32
    t = f32(min(count, cfg["lr_decay_steps"]))
    x = f32(np.pi) * t / f32(cfg["lr_decay_steps"])
    decay = f32(0.5) * (f32(1) + f32(math.cos(float(x))))
    alpha = cfg["lr_final_fraction"]
    return float(f32(cfg["lr"]) * (f32(1 - alpha) * decay + f32(alpha)))


def alpha_schedule(n: int, delta_m: int) -> float:
    return 1.0 if n > delta_m / 2 else n * 2.0 / delta_m


class Recorded:
    """The program's RM+ solves, in the order it made them, as the
    reference's solver.  RM+ in float32 is sensitive to the order of its
    sums (a regret at 0 is clipped in one order and not in another), so no
    independent solve reproduces the program's on the games where it
    ties; the reference takes each recorded solve for the games whose
    payoffs and legality equal the record's and solves the others (those
    of lanes whose episodes went another way) itself.  ``check.py`` holds
    the recorded solves against the plain RM+ by themselves."""

    def __init__(self, records, iters: int):
        self.records = list(records)
        self.iters = iters
        self.calls = 0

    def __call__(self, M, lr, lc):
        rec = (self.records[self.calls] if self.calls < len(self.records)
               else None)
        self.calls += 1
        same = torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
        if rec is not None and tuple(rec[0].shape) == tuple(M.shape):
            rM, rl, rc = (t.to(M.device) for t in rec[:3])
            same = ((rM == M).flatten(1).all(1) & (rl == lr).all(1)
                    & (rc == lc).all(1))
        x = torch.empty((M.shape[0], M.shape[1]), device=M.device)
        y = torch.empty((M.shape[0], M.shape[2]), device=M.device)
        v = torch.empty((M.shape[0],), device=M.device)
        if bool(same.any()):
            x[same], y[same], v[same] = (t.to(M.device)[same]
                                         for t in rec[3:])
        other = ~same
        if bool(other.any()):
            x[other], y[other], v[other] = nets.solve(
                M[other], lr[other], lc[other], self.iters)
        return x, y, v


# the control's RM+: the type below the float32 that the program's RM+
# (kernel K3) computes in
CONTROL_SOLVE = torch.bfloat16


class Solving:
    """The plain RM+ in ``dtype`` as the reference's solver, recording each
    solve (M, lr, lc, x, y, v) on the host as ``system.recorded_solves``
    records the program's."""

    def __init__(self, iters: int, dtype: torch.dtype):
        self.iters = iters
        self.dtype = dtype
        self.records = []

    def __call__(self, M, lr, lc):
        out = nets.solve(M, lr, lc, self.iters, self.dtype)
        self.records.append(tuple(t.detach().float().cpu()
                                  for t in (M, lr, lc) + tuple(out)))
        return out


@dataclasses.dataclass
class Readings:
    """What the check compares, from the program or the reference: each
    checked step's (loss_v, loss_nerd); the first rollout (indices,
    actions, rewards as (T, B), the behavior policy as (T, B, A) and the
    stored observations as (T, B, C, A, A)); and
    per parameter (state_dict order) the norms of the first gradient as
    Adam holds it, of the change of the weights and of the EMA target over
    the checked steps, and of Adam's second moment after them."""

    losses: List[tuple]
    rollout: Dict[str, torch.Tensor]
    grad: Dict[str, float]
    change: Dict[str, float]
    target_change: Dict[str, float]
    moment: Dict[str, float]
    # the later checked steps' rollouts (indices, actions, rewards)
    later: List[Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    # the RM+ solves (M, lr, lc, x, y, v), where the net solves: the
    # program's, or the control's own
    solves: Optional[list] = None
    # where the net keeps state (BatchNorm's running averages): per buffer
    # the norm of its change over the checked steps, the learner's under
    # "net.<name>" and the EMA target's under "target.<name>"
    state: Optional[Dict[str, float]] = None


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def grad_norms(nu: Dict[str, torch.Tensor], b2: float) -> Dict[str, float]:
    """The first gradient's norm per leaf from Adam's second moment after
    one update, nu = (1 - b2) g^2."""
    return {k: math.sqrt(float(t.double().sum()) / (1.0 - b2))
            for k, t in nu.items()}


def state_changes(state: Dict[str, torch.Tensor],
                  target: Dict[str, torch.Tensor],
                  state0: Dict[str, torch.Tensor]) -> Optional[Dict[str,
                                                                  float]]:
    """``Readings.state`` of the learner's and the target's state against
    where both started; None for a net that keeps none."""
    if not state0:
        return None
    return {**norms({f"net.{k}": state[k] - v for k, v in state0.items()}),
            **norms({f"target.{k}": target[k] - v
                     for k, v in state0.items()})}


def run(game: Game, config: dict, lanes: int, params0: Dict[str,
                                                         torch.Tensor],
        noise_seed: int, steps: int, precision: Optional[str] = None,
        device="cuda", solves: Optional[list] = None) -> Readings:
    """``steps`` train steps from ``params0`` (all four nets start there,
    with its state where the net keeps state) with the rollout noise of
    ``noise_seed``, in the configuration's precision or ``precision``.  A
    net that solves games takes the program's ``solves`` where given
    (``Recorded``); in another ``precision`` (the control) it solves them
    itself with the plain RM+ in ``CONTROL_SOLVE`` and its readings hold
    those solves (``Solving``), as the program's hold its own."""
    net, cfg = config["net"], config["rnad"]
    prec = nets.Precision(precision or net["compute_dtype"])
    forward = nets.family(net).forward
    kept = {name for name, _, _ in nets.state_shapes(
        net, game.A, nets.in_channels(config))}
    p0 = {k: v.detach().to(device).float() for k, v in params0.items()
          if k not in kept}
    state0 = {k: v.detach().to(device).float() for k, v in params0.items()
              if k in kept}
    learner = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    target = {k: v.clone() for k, v in p0.items()}
    reg, reg_prev = dict(p0), dict(p0)
    state = {k: v.clone() for k, v in state0.items()}
    target_state = {k: v.clone() for k, v in state0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    losses, first, nu1, later = [], None, None, []
    b1, b2, eps = cfg["b1_adam"], cfg["b2_adam"], cfg["epsilon_adam"]
    iters = net.get("solver_iters", 0)
    solver = None
    if precision is not None and iters:
        solver = Solving(iters, CONTROL_SOLVE)
    elif solves is not None:
        solver = Recorded(solves, iters)
    for n in range(steps):
        actor = lambda obs: forward(learner, obs, net, prec,
                                    nets.features(net, obs, solver),
                                    state=state)
        traj = rollout(game, actor, lanes, gen, device)
        if first is None:
            first = {k: traj[k].cpu() for k in ("indices", "actions",
                                                "rewards", "policy", "obs")}
        else:
            later.append({k: traj[k].cpu() for k in ("indices", "actions",
                                                     "rewards")})
        scale = (1.0 if n >= cfg["policy_warmup_steps"] else 0.0)
        alpha = alpha_schedule(n, cfg["delta_m"][0])
        loss, lv, ln = learner_loss(
            learner, ((target, target_state), (reg, state0),
                      (reg_prev, state0)), traj, game, net, cfg, alpha,
            scale, prec, solver, state)
        losses.append((float(lv.detach()), float(ln.detach())))
        del traj
        grads = dict(zip(learner, torch.autograd.grad(
            loss, list(learner.values()))))
        with torch.no_grad():
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            lr = learning_rate(cfg, n)
            # optax's bias corrections, float32 on its side
            c1 = float(np.float32(1) - np.float32(b1) ** np.int32(n + 1))
            c2 = float(np.float32(1) - np.float32(b2) ** np.int32(n + 1))
            for k, p in learner.items():
                g = grads[k]
                if g_norm >= cfg["grad_clip"]:
                    g = g / g_norm * cfg["grad_clip"]
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
                update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                p += (-lr) * update
                target[k] = (cfg["gamma_averaging"] * p
                             + (1.0 - cfg["gamma_averaging"]) * target[k])
            for k, v in state.items():
                target_state[k] = (cfg["gamma_averaging"] * v
                                   + (1.0 - cfg["gamma_averaging"])
                                   * target_state[k])
        if n == 0:
            nu1 = {k: v.clone() for k, v in nu.items()}
    with torch.no_grad():
        return Readings(
            losses=losses, rollout=first, grad=grad_norms(nu1, b2),
            change=norms({k: learner[k] - p0[k] for k in p0}),
            target_change=norms({k: target[k] - p0[k] for k in p0}),
            moment=norms(nu), later=later,
            solves=solver.records if isinstance(solver, Solving) else None,
            state=state_changes(state, target_state, state0))
