"""Kernel K4 (``ops/equinet.py``) against the eager no-grad forwards, at
the learner's and the rollout's shapes, on a CUDA card.

    python3 -m rnad_tpu_torch.equinet_probe [--n 393216] [--nets 3]

Three frozen EquiNets of the flagship's shape (A = 5, 64 channels, depth 2,
128 RM+ iterations, primed, bfloat16; ``--channels``, ``--depth``,
``--actions``, ``--solver-iters``, ``--unprimed`` change it), drawn from
``--seed`` with the primed heads drawn too (at zero they would hide the
tower) and each frozen net moved off the others, run over ``--n`` random
observations with illegal actions (value 0 on an illegal cell) and their
solver features (K3); ``--nets 1`` keeps the first net alone, as a
rollout turn (``--n 65536``) or a NashConv chunk launches it.  Prints one
JSON line: for the target's logits and values and the reg nets' logits
(those of the nets run), the share of elements that differ from
the eager passes and the largest gap in bf16 units in the last place
(``differences``); whether two launches agree bitwise; K4's time (CUDA
events over ``--iters`` launches after a warm one), the eager passes'
time, K4's bound (``operations`` at the H100 SXM's dense bf16 rate,
``io_bytes`` at its HBM rate) and its share, the card and its power limit.

    python3 -m rnad_tpu_torch.equinet_probe --rollout-seeds 20

instead plays flagship rollouts (the native generator's 785,768-node A = 5
tree, 32,768 lanes, the primed bf16 EquiNet drawn from each seed 0, 1,
...) twice on the same noise, with K4 in every generic turn and with the
net's eager forward, and prints one JSON line a seed and a summary: the
lanes whose indices or actions part, and the share of policy and value
elements that differ.  Without a card it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .config import NetConfig, ShapingRule, TreeConfig
from .env import engine
from .env import tree as tree_lib
from .models import nets
from .ops import equinet, stepping
from .roofline import H100_SXM

PEAK_BF16, PEAK_BYTES = H100_SXM.flops_bf16, H100_SXM.hbm_bytes_per_s


def observations(n: int, A: int, seed: int, device) -> torch.Tensor:
    """(n, 2, A, A): payoffs N(0, 1) on legal cells, legality the outer
    product of row and column masks with at least one legal action each."""
    rng = np.random.default_rng(seed)
    lr = rng.random((n, A)) < 0.7
    lc = rng.random((n, A)) < 0.7
    lr[:, 0] = lc[:, 0] = True
    legal = (lr[:, :, None] & lc[:, None, :]).astype(np.float32)
    ev = rng.normal(size=(n, A, A)).astype(np.float32) * legal
    return torch.from_numpy(np.stack([ev, legal], axis=1)).to(device)


def frozen_nets(A: int, C: int, depth: int, solver_iters: int,
                primed: bool, seed: int, device):
    """Three bfloat16 EquiNets: one drawn from ``seed`` (its primed heads
    too) and two more moved off it by 0.01 N(0, 1) a parameter."""
    cfg = NetConfig(type="EquiNet", max_actions=A, channels=C, depth=depth,
                    solver_iters=solver_iters, solver_prime=primed,
                    compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(seed)
    out = []
    for k in range(3):
        net = nets.build_net(cfg, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            if net.primed:
                for head in (net.policy, net.value):
                    head.weight.normal_(0.0, 0.1, generator=g)
                    head.bias.normal_(0.0, 0.1, generator=g)
            if k:
                for p in net.parameters():
                    p.add_(0.01 * torch.randn(p.shape, generator=g))
        out.append(net.to(device).requires_grad_(False))
    return tuple(out)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def differences(got: torch.Tensor, want: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> dict:
    """How far the kernel's float32 outputs ``got`` lie from the eager
    passes' ``want``: the share of elements that differ, and the largest
    gap in bfloat16 units in the last place of the larger of |want| and
    |scale| (2^(e - 7) for a magnitude in [2^e, 2^(e+1)); the smallest
    normal's below it).  ``scale``: the bf16 head's own output where a
    primed gate's term was added after it (a head's rounding is a unit of
    the head, not of the sum)."""
    want = want.float()
    gap = (got.float() - want).abs()
    mag = want.abs() if scale is None else torch.maximum(want.abs(),
                                                         scale.abs())
    _, e = torch.frexp(mag.clamp(min=torch.finfo(torch.float32).tiny))
    ulps = gap / torch.ldexp(torch.ones_like(want), e - 8)
    return {"differ_share": float((gap != 0).float().mean()),
            "max_ulps": float(ulps.max()) if ulps.numel() else 0.0,
            "nonfinite": int((~torch.isfinite(got)).sum())}


def compare(frozen, got, want, feats) -> dict:
    """``differences`` of the target's logits and values and the reg
    nets' logits (of the nets in ``frozen``), each primed output measured
    in units of its bf16 head (the output less the gate's term)."""
    out = {}
    for name, k, field in (("target_logits", 0, 0), ("target_values", 0, 1),
                           ("reg_logits", 1, 0), ("reg_prev_logits", 2, 0)):
        if k >= len(frozen):
            continue
        scale = None
        if frozen[k].primed:
            gate = (frozen[k].policy_prime_gate if field == 0
                    else frozen[k].value_prime_gate)
            scale = want[k][field] - gate * feats[1 + field]
        out[name] = differences(got[k][field], want[k][field], scale)
    return out


@torch.no_grad()
def probe(n: int, A: int = 5, C: int = 64, depth: int = 2,
          solver_iters: int = 128, primed: bool = True, seed: int = 0,
          iters: int = 20, nets_run: int = 3) -> dict:
    dev = torch.device("cuda")
    frozen = frozen_nets(A, C, depth, solver_iters, primed, seed,
                         dev)[:nets_run]
    obs = observations(n, A, seed + 1, dev)
    feats = (nets.equinet_solver_features(frozen[0], obs) if solver_iters
             else None)
    dtype = torch.bfloat16
    why = equinet.unsupported(frozen, obs, feats, dtype)
    if why is not None:
        raise ValueError(f"K4 does not take {why}")
    want = equinet.equinet_frozen_plain(frozen, obs, feats, dtype)
    got = equinet.equinet_frozen(frozen, obs, feats, dtype)
    again = equinet.equinet_frozen(frozen, obs, feats, dtype)
    c0 = equinet.input_channels(frozen[0])
    ops = equinet.operations(n, A, C, depth, c0, nets=nets_run)
    io = equinet.io_bytes(n, A, C, depth, 2, c0, nets=nets_run,
                          primed=frozen[0].primed)
    bound_s = max(ops / PEAK_BF16, io / PEAK_BYTES)
    k4 = _time_ms(lambda: equinet.equinet_frozen(frozen, obs, feats, dtype),
                  iters)
    eager = _time_ms(lambda: equinet.equinet_frozen_plain(
        frozen, obs, feats, dtype), max(1, iters // 4))
    return {"n": n, "nets": nets_run, "A": A, "C": C, "depth": depth,
            "c0": c0, "primed": frozen[0].primed,
            "outputs": compare(frozen, got, want, feats),
            "deterministic": all(torch.equal(x, y)
                                 for g, h in zip(got, again)
                                 for x, y in zip(g, h)),
            "operations": ops, "io_bytes": io,
            "bound_ms": 1e3 * bound_s,
            "bound_by": "operations" if ops / PEAK_BF16 >= io / PEAK_BYTES
            else "bytes",
            "k4_ms": k4, "eager_ms": eager,
            "k4_share_pct": 100.0 * 1e3 * bound_s / k4,
            "device": torch.cuda.get_device_name(dev),
            "power_limit": _power_limit()}


# flagship-3's tree (docs/runs/r4-flagship3.params.json; the native
# generator, seed 0: 785,768 nodes) and its rollout's lanes
FLAGSHIP_TREE = TreeConfig(
    max_actions=5, max_transitions=2, depth_bound=6,
    transition_threshold=0.25,
    depth_bound_rule=ShapingRule(delta=-1, stochastic_delta=-2,
                                 stochastic_prob=0.55))
FLAGSHIP_LANES = 32768


class _Eager(torch.nn.Module):
    """``net`` behind a module that is not an EquiNet: its own forward in
    every generic turn, never K4."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, obs):
        return self.net(obs)


@torch.no_grad()
def rollout_parts(seeds: int, lanes: int = FLAGSHIP_LANES,
                  solver_iters: int = 128):
    """Yields, for each seed, how far a flagship rollout with K4 parts
    from the same rollout with the eager forward on the same noise."""
    dev = torch.device("cuda")
    tree = tree_lib.generate_tree_native(FLAGSHIP_TREE, seed=0,
                                         device="cpu").to(dev)
    packed = stepping.make_packed_tables(tree)
    A, T = tree.max_actions, tree.max_transitions
    init = torch.ones((lanes,), dtype=torch.int32, device=dev)
    for seed in range(seeds):
        net = frozen_nets(A, 64, 2, solver_iters, True, seed, dev)[0]
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = [engine.turn_noise(lanes, A, T, gen, dev)
                 for _ in range(tree.max_depth)]
        before = equinet.equinet_frozen.launches
        got, want = (engine.rollout_from(tree, packed, n, init, noise=noise)
                     for n in (net, _Eager(net)))
        parted = ((got.indices != want.indices).any(0)
                  | (got.actions != want.actions).any(0))
        yield {"seed": seed, "nodes": tree.size, "lanes": lanes,
               "k4_launches": equinet.equinet_frozen.launches - before,
               "lanes_parted": int(parted.sum()),
               "policy_differ_share": float(
                   (got.policy != want.policy).float().mean()),
               "values_differ_share": float(
                   (got.values != want.values).float().mean())}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=393216)
    parser.add_argument("--actions", type=int, default=5)
    parser.add_argument("--channels", type=int, default=64)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--solver-iters", type=int, default=128)
    parser.add_argument("--unprimed", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--nets", type=int, default=3, choices=(1, 2, 3))
    parser.add_argument("--rollout-seeds", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.rollout_seeds:
        rows = []
        for row in rollout_parts(args.rollout_seeds,
                                 solver_iters=args.solver_iters):
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({
            "seeds": len(rows),
            "lanes_parted": sum(r["lanes_parted"] for r in rows),
            "of_lanes": sum(r["lanes"] for r in rows),
            "policy_differ_share": max(r["policy_differ_share"]
                                       for r in rows),
            "values_differ_share": max(r["values_differ_share"]
                                       for r in rows),
            "device": torch.cuda.get_device_name(0),
            "power_limit": _power_limit()}), flush=True)
        return 0
    print(json.dumps(probe(args.n, args.actions, args.channels, args.depth,
                           args.solver_iters, not args.unprimed, args.seed,
                           args.iters, args.nets)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
