"""The comparison that decides ``correct``: the program's readings of its
first train steps against the plain reference's, at the timed sizes.

Numbers, each held to the cell's limit (``limits/<cell>.json``):

* ``lanes_diverged``: the share of the first rollout's lanes whose
  states, actions or rewards differ anywhere (the same weights and noise
  play the same episodes, but for near-ties of the Gumbel-max);
* ``policy_gap``: the mean, over the valid half-steps of the lanes that
  agree, of the largest gap between the two behavior policies;
* ``obs_gap``: the largest gap, over the lanes that agree, between the
  observations the program stored in the first rollout (kernel K1 writes
  them on the fused turn) and the reference's (exact: both are the tree's
  numbers);
* ``first_loss_gap``: the first step's largest gap of the critic or the
  NeuRD loss, over the sum of the reference's two magnitudes, and
  ``loss_gap`` the same over every checked step (a reading; the later
  steps' losses part at near-ties of the Gumbel-max once the two runs'
  weights differ by rounding, so a cell compares the first);
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as Adam holds it (its second moment after one update), over
  the larger of the reference's norm of that leaf and the median leaf's;
* ``change_gap``, ``target_gap``, ``moment_gap``: the same of the change
  of the weights, of the EMA target over the checked steps and of Adam's
  second moment after them, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (a leaf below that, such as a
  bias that the softmax cancels, moves under Adam by round-off alone);
* ``later_lanes_diverged``: ``lanes_diverged`` of the later checked
  steps' rollouts, the largest (a reading: where the weights already
  differ by rounding, a lane may part at a near-tie);
* ``state_gap``, where both readings hold a net's state that is not
  trained (a ConvNet's BatchNorm running averages): the worst buffer's
  gap between the norms of its change over the checked steps, the
  learner's and the EMA target's, over the larger of the reference's norm
  of that buffer and the median buffer's.

Where the net solves games with RM+ (the EquiNet's features, kernel K3),
the reference follows the program step by step from the program's own
solves (``reference/rnad.py::Recorded``), and the solves, the stage that
this skips, are held by themselves against the plain RM+ on the same
games:

* ``solve_far``: the share of the checked steps' games whose strategies
  or value differ from the plain solve's by more than 1e-3;
* ``solve_diverged``: the same share at 1e-5 (a reading: RM+ in float32
  parts at ties, where a regret at 0 is clipped in one order of the sums
  and not in another, on some 6-7 % of the games);
* ``solve_excess``: the mean over those games of the program's
  exploitability less the plain solve's.

The control's readings hold its own solves (the plain RM+ in the type
below float32), held against the plain RM+ the same way.

A number that is not finite fails.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from .reference.rnad import Readings

HERE = Path(__file__).resolve().parent
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
KEEP = 1e-3
SOLVE_NEAR, SOLVE_FAR = 1e-5, 1e-3


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    base = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], base) for k in keys)


def _parted(g, w) -> torch.Tensor:
    """The lanes whose states, actions or rewards differ anywhere."""
    return ((g["indices"] != w["indices"]) | (g["actions"] != w["actions"])
            | (g["rewards"] != w["rewards"])).any(0)


def numbers(got: Readings, want: Readings, iters: int = 0,
            device="cpu") -> Dict[str, float]:
    """The numbers of the module docstring; the solves' where ``got``
    holds them (``iters`` the RM+ iterations)."""
    g, w = got.rollout, want.rollout
    diff = _parted(g, w)
    agree = ~diff
    valid = (w["indices"] != 0) & agree[None]
    gap = (g["policy"] - w["policy"]).abs().amax(-1)
    losses = [max(abs(a - b) for a, b in zip(pg, pw))
              / (abs(pw[0]) + abs(pw[1]))
              for pg, pw in zip(got.losses, want.losses)]
    leaves = list(want.grad)
    median = statistics.median(want.grad[k] for k in leaves)
    kept = [k for k in leaves if want.grad[k] >= KEEP * median]
    if g.get("obs") is not None:
        obs_gap = float((g["obs"].float() - w["obs"].float())[:, agree]
                        .abs().amax()) if bool(agree.any()) else 0.0
    else:
        obs_gap = float("nan")
    out = {
        "lanes_diverged": float(diff.float().mean()),
        "obs_gap": obs_gap,
        "policy_gap": float(gap[valid].mean()) if bool(valid.any())
        else float("nan"),
        "first_loss_gap": losses[0],
        "loss_gap": max(losses),
        "grad_gap": _leaf_gap(got.grad, want.grad, leaves),
        "change_gap": _leaf_gap(got.change, want.change, kept),
        "target_gap": _leaf_gap(got.target_change, want.target_change, kept),
        "moment_gap": _leaf_gap(got.moment, want.moment, kept),
        "later_lanes_diverged": max(
            [float(_parted(a, b).float().mean())
             for a, b in zip(got.later, want.later)], default=0.0),
    }
    if got.state and want.state:
        out["state_gap"] = _leaf_gap(got.state, want.state, list(want.state))
    if got.solves:
        out.update(solve_numbers(got.solves, iters, device))
    return out


def exploitability(M, lr, lc, x, y):
    """max_r (M y)_r - min_c (x M)_c over the legal actions, with the
    illegal cells of M zeroed."""
    Mz = M * lr[:, :, None] * lc[:, None, :]
    best = torch.where(lr > 0, torch.einsum("nrc,nc->nr", Mz, y),
                       torch.full_like(lr, -1e30)).amax(-1)
    worst = torch.where(lc > 0, torch.einsum("nr,nrc->nc", x, Mz),
                        torch.full_like(lc, 1e30)).amin(-1)
    return best - worst


@torch.no_grad()
def solve_numbers(records, iters: int, device) -> Dict[str, float]:
    """The recorded solves (M, lr, lc, x, y, v) against the plain RM+ in
    float32 on the same games."""
    from .reference import nets

    games = near = far = 0
    excess = 0.0
    for rec in records:
        M, lr, lc, x, y, v = (t.to(device) for t in rec)
        want = nets.solve(M, lr, lc, iters)
        err = torch.maximum(torch.maximum(
            (x - want[0]).abs().amax(-1), (y - want[1]).abs().amax(-1)),
            (v - want[2]).abs())
        games += M.shape[0]
        near += int((err > SOLVE_NEAR).sum())
        far += int((err > SOLVE_FAR).sum())
        excess += float((exploitability(M, lr, lc, x, y)
                         - exploitability(M, lr, lc, *want[:2])).double()
                        .sum())
    return {"solve_diverged": near / games, "solve_far": far / games,
            "solve_excess": excess / games}


def limits(cell: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())[
        "limits"]


def judge(values: Dict[str, float], lims: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number the cell compares
    (those its limits name) at or under its limit; a number missing or
    not finite fails."""
    table = {k: {"value": values.get(k, float("nan")), "limit": lim}
             for k, lim in lims.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table


def failed(table: Dict[str, dict]) -> List[str]:
    """The names of ``table`` (``judge``'s) that fail, and whether each
    failed on a number or on one that is missing or not finite."""
    return [k if math.isfinite(v["value"]) else f"{k} (no number)"
            for k, v in table.items() if not v["value"] <= v["limit"]]


def lines(table: Dict[str, dict]) -> List[str]:
    return [f"{k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in table.items()]
