"""The plain EquiNet (``rnad_tpu/models/nets.py``'s EquiNet): row/column-
exchangeable layers over the channels-last observation with the RM+ solver
channels, a policy head on each row's mean and a value head on the global
mean, and with ``solver_prime`` the solve's log x and value through the
gates."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nets import Params, Precision, solve


@torch.no_grad()
def solver_features(obs: torch.Tensor, iters: int, solver=None):
    """The EquiNet's six RM+ channels of (N, 2, A, A) observations, and
    its primers: (feats (N, A, A, 6), log x (N, A), value (N,)), float32.
    ``solver(M, lr, lc)`` gives the solve (default ``solve``)."""
    M = obs[:, 0].float()
    legal = obs[:, 1].float()
    lr, lc = legal.amax(2), legal.amax(1)
    x, y, v = (solver(M, lr, lc) if solver is not None
               else solve(M, lr, lc, iters))
    u_r = torch.einsum("nrc,nc->nr", M, y)
    u_c = -torch.einsum("nr,nrc->nc", x, M)
    log_x = torch.log(x + 1e-9)
    rows = [x, log_x, u_r]
    cols = [y, torch.log(y + 1e-9), u_c]
    feats = ([r[:, :, None].expand(M.shape) for r in rows]
             + [c[:, None, :].expand(M.shape) for c in cols])
    return torch.stack(feats, -1), log_x, v


def _exchangeable(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """concat([cell, row mean, column mean, mean, row max, column max]) @
    kernel + bias, each pool contracted un-broadcast against its block of
    the kernel and the results broadcast-added."""
    cin = h.shape[-1]
    h = h.to(prec.dtype)
    pools = [h, h.mean(2, keepdim=True), h.mean(1, keepdim=True),
             h.mean((1, 2), keepdim=True), h.amax(2, keepdim=True),
             h.amax(1, keepdim=True)]
    out = None
    for i, pool in enumerate(pools):
        term = prec.mm(pool, kernel[i * cin:(i + 1) * cin])
        out = term if out is None else out + term
    return out + bias.to(prec.dtype)


def forward(params: Params, obs: torch.Tensor, net: dict,
            prec: Precision, feats=None, state=None, train: bool = False,
            mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, A, A) observations -> (logits (N, A), values (N,)): the
    channels-last observation with the solver channels, ``depth``
    exchangeable layers with ReLU, a policy head on each row's mean and a
    value head on the global mean, both beside the input's same pools, and
    with ``solver_prime`` the solve's log x and value through the gates.
    ``feats`` is ``solver_features`` of the same observations.  The
    EquiNet keeps no state and has no train mode."""
    del state, train, mask
    x = obs.permute(0, 2, 3, 1)
    iters = net.get("solver_iters", 0)
    if iters:
        if feats is None:
            feats = solver_features(obs, iters)
        x = torch.cat([x, feats[0]], -1)
    x = x.to(prec.dtype)
    x0 = x
    for i in range(net["depth"]):
        x = torch.relu(_exchangeable(x, params[f"ex{i}.kernel"],
                                     params[f"ex{i}.bias"], prec))
    row = torch.cat([x.mean(2), x0.mean(2)], -1)
    glob = torch.cat([x.mean((1, 2)), x0.mean((1, 2))], -1)
    logits = prec.dense(row, params["policy.weight"],
                        params["policy.bias"])[..., 0].float()
    value = prec.dense(glob, params["value.weight"],
                       params["value.bias"])[:, 0].float()
    if iters and net.get("solver_prime", False):
        logits = logits + params["policy_prime_gate"] * feats[1]
        value = value + params["value_prime_gate"] * feats[2]
    return logits, value


def features(net: dict, obs: torch.Tensor, solver=None) -> Optional[tuple]:
    """What every pass over ``obs`` shares: the solve."""
    if net.get("solver_iters", 0):
        return solver_features(obs, net["solver_iters"], solver)
    return None


def param_shapes(net: dict, A: int, in_channels: int = 2):
    """The leaves at A actions and ``in_channels`` input channels in the
    program's state_dict order: (name, shape, bound), each starting
    U(-bound, bound), torch's Linear default of its layer; a bound of None
    marks a gate that starts at 1."""
    C = net["channels"]
    c0 = in_channels + (6 if net.get("solver_iters", 0) else 0)
    out, cin = [], c0
    if net.get("solver_iters", 0) and net.get("solver_prime", False):
        out += [("policy_prime_gate", (), None),
                ("value_prime_gate", (), None)]
    for i in range(net["depth"]):
        out += [(f"ex{i}.kernel", (6 * cin, C), (6 * cin) ** -0.5),
                (f"ex{i}.bias", (C,), (6 * cin) ** -0.5)]
        cin = C
    for head in ("policy", "value"):
        out += [(f"{head}.weight", (1, C + c0), (C + c0) ** -0.5),
                (f"{head}.bias", (1,), (C + c0) ** -0.5)]
    return out
