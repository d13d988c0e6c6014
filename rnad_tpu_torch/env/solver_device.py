"""On-device batched approximate zero-sum solver (Regret Matching+).

Counterpart of ``rnad_tpu/env/solver_device.py``.  The loop itself is
kernel K3 (``ops/rmplus.py``); its plain version ``rmplus_plain`` is this
module's ``rmplus_core``, one source for both names.  There is no mode
switch and no size crossover: every solve goes through ``rmplus``, which
launches K3 for CUDA tensors at any batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.rmplus import rmplus
from ..ops.rmplus import rmplus_plain as rmplus_core  # noqa: F401

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def solve_zero_sum_rmplus(payoffs: torch.Tensor, legal_rows: torch.Tensor,
                          legal_cols: torch.Tensor, iters: int = 2000
                          ) -> _Outputs:
    """Batched RM+ for zero-sum matrix games.

    ``payoffs`` (B, R, C) row-player payoffs, ``legal_rows`` (B, R) and
    ``legal_cols`` (B, C) {0, 1} masks -> (x (B, R), y (B, C), v (B,)):
    linear-averaged strategies (zero on illegal actions, summing to 1) and
    their bilinear value.  The solve runs batch-minor, as K3 takes it."""
    dtype = payoffs.dtype
    lr_m = legal_rows.to(dtype)
    lc_m = legal_cols.to(dtype)
    # illegal cells never contribute utility
    M = (payoffs * lr_m[:, :, None] * lc_m[:, None, :]).permute(1, 2, 0)
    x, y, v = rmplus(M.contiguous(), lr_m.t().contiguous(),
                     lc_m.t().contiguous(), iters)
    return x.t(), y.t(), v


@torch.no_grad()
def joint_policy_rmplus(tree, iters: int = 2000,
                        chunk: int = 200_000) -> torch.Tensor:
    """Both-seat joint policy (S, 2A) that plays the RM+ epsilon-Nash of
    each node's observed payoff matrix, ``chunk`` nodes per solve."""
    S = tree.index.shape[0]
    outs = []
    for start in range(0, S, min(chunk, S)):
        stop = min(start + chunk, S)
        ev = tree.expected_value[start:stop, 0]
        lg_r = tree.legal[start:stop, 0, :, 0]
        lg_c = tree.legal[start:stop, 0, 0, :]
        x, y, _ = solve_zero_sum_rmplus(ev, lg_r, lg_c, iters=iters)
        outs.append(torch.cat([x, y], dim=-1))
    return torch.cat(outs, dim=0)


def exploitability_batch(payoffs: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, legal_rows: torch.Tensor,
                         legal_cols: torch.Tensor) -> torch.Tensor:
    """(B,) max_r (M y)_r - min_c (x M)_c over the legal actions."""
    best_row = torch.where(legal_rows > 0,
                           torch.einsum("brc,bc->br", payoffs, y),
                           torch.full_like(x, -1e30)).amax(-1)
    worst_col = torch.where(legal_cols > 0,
                            torch.einsum("br,brc->bc", x, payoffs),
                            torch.full_like(y, 1e30)).amin(-1)
    return best_row - worst_col


@dataclasses.dataclass
class Agreement:
    """Two float32 RM+ solves of the same games, compared (``agreement``).
    Exploitabilities are (got, want) pairs."""

    games: int
    diverged: int  # games where x, y or v differ by more than ATOL
    max_abs_err: float  # largest difference on the other games
    excess: Tuple[float, float]  # least and largest got - want, per game
    mean_expl: Tuple[float, float]  # over all games
    mean_expl_diverged: Tuple[float, float]  # over the diverged games
    max_expl: Tuple[float, float]  # the worst game of each
    ok: bool


ATOL = 1e-5
DIVERGED_SHARE = 0.03
MEAN_EXCESS = 1e-5
DIVERGED_MEAN_EXCESS = 2e-3
MAX_EXCESS = 1e-3


@torch.no_grad()
def agreement(payoffs: torch.Tensor, legal_rows: torch.Tensor,
              legal_cols: torch.Tensor, got, want, v_got: torch.Tensor,
              v_want: torch.Tensor) -> Agreement:
    """Compares two solves ``got = (x, y)`` and ``want`` of the games
    ``payoffs`` (B, R, C) (illegal cells zeroed), batch-major.

    RM+ in float32 is sensitive to the order of its sums: a regret that
    hovers at 0 is clipped in one order and stays positive in another, and
    from there the two runs take different branches of ``normalize``.  In
    games with tied payoffs (the tree's terminal values are exactly +-1)
    the two runs may then end at different points, one at an exact
    equilibrium and one near it, so a single game's exploitability can
    differ either way by a few 1e-2.  So x, y and v must agree within
    ``ATOL`` except on a counted share of diverged games (at most
    ``DIVERGED_SHARE``), and the diverged games must be as good as
    ``want``'s as a set: the mean exploitability over all games within
    ``MEAN_EXCESS``, over the diverged games within
    ``DIVERGED_MEAN_EXCESS``, and the worst game within ``MAX_EXCESS`` of
    ``want``'s worst.  (Two orders of the same sums, rnad_tpu's XLA loop and
    ``rmplus_plain`` on the CPU, diverge on 1.4 % of random A = 5 games and
    0.35 % of the A = 5 tree's observed games at 128 iterations; the means
    agree to 5e-7, the worst games to 6e-8.)"""
    B = payoffs.shape[0]
    err = torch.zeros((B,), device=payoffs.device)
    for a, b in zip(got, want):
        err = torch.maximum(err, (a - b).abs().amax(-1))
    err = torch.maximum(err, (v_got - v_want).abs())
    expl = [exploitability_batch(payoffs, x, y, legal_rows, legal_cols)
            for x, y in (got, want)]
    bad = err > ATOL
    diverged = int(bad.sum())
    agree = err[~bad]
    pair = lambda f, sel: ((float(f(expl[0][sel])), float(f(expl[1][sel])))
                           if bool(sel.any()) else (0.0, 0.0))
    every = torch.ones_like(bad)
    diff = expl[0] - expl[1]
    mean_all = pair(torch.mean, every)
    mean_div = pair(torch.mean, bad)
    worst = pair(torch.amax, every)
    ok = (diverged <= DIVERGED_SHARE * B
          and mean_all[0] <= mean_all[1] + MEAN_EXCESS
          and mean_div[0] <= mean_div[1] + DIVERGED_MEAN_EXCESS
          and worst[0] <= worst[1] + MAX_EXCESS)
    return Agreement(
        games=B, diverged=diverged,
        max_abs_err=float(agree.max()) if agree.numel() else 0.0,
        excess=(float(diff.min()), float(diff.max())) if B else (0.0, 0.0),
        mean_expl=mean_all, mean_expl_diverged=mean_div, max_expl=worst,
        ok=ok)
