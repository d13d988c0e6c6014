"""Rollout engine variants at production shapes.

Counterpart of ``tools/rollout_probe.py``.

    python3 -m rnad_tpu_torch.rollout_probe [--batch 131072] [--iters 256] \\
        [--variants base,fused] [--cpu]

Variants (comma list via ``--variants``), the tool's grammar:

- ``base``: the generic turn (``rows_actor="off"``): the lanes' packed
  rows (K2), both seats' observations through the net, the masked policy,
  the Gumbel-max actions and the transition;
- ``fused``: every turn one launch of kernel K1 (``rows_actor="on"``);
- ``chunkN`` and ``fused_chunkN``: the same with ``lane_chunks=N``, the
  lanes rolled out as N sequential sub-batches (``env/engine.py``).

The tool's ``*_pmin`` variants record the behavior policy as (T, A, B) for
``rnad_tpu``'s batch-minor learner; the port records (T, B, A) only, so
it has none.

It rolls out on the tool's tree (the reference demo tree, A = 3, depth
bound 4, seed 0; ``bench.TREE_CONFIG``) with the tool's width-256 MLP
(drawn from seed 0), ``--batch`` lanes from the root.  Each variant
warms up (``bench.WARM_ROLLOUTS`` rollouts, the first building the
kernels), then runs ``--iters`` rollouts back to back under a host clock
that ends in one fetch, as ``bench.py`` times its rollouts (torch has no
scan: the host's enqueue is part of the rate).  The tool's self-checks
ride in the timed loop on the device and are read at its end: the lowest
per-lane std of the episode signature (``bench.measured``) must be
positive, or it raises; a mean return outside [-1, 1] is flagged on a
``#`` line, and the row is still printed.

Prints one JSON row a variant (``variant``, ``half_steps_per_s``,
``dt_s``: the timed loop's seconds, ``mean_return``, ``lane_chunks``,
``k1_per_rollout`` and ``k2_per_rollout``: the kernels'
launches a timed rollout, counted on the card only, ``peak_mem_gib``: the
device's peak memory over the variant, on the card only, ``device``,
``power_limit_w``), then each variant's rate over ``base``'s where
``base`` ran.  Runs on the card unless ``--cpu`` is given, and without a
card exits nonzero before printing anything.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import bench
from .env import tree as tree_lib
from .ops import fused_turn, lookup, stepping

BATCH, ITERS = 1 << 17, 256  # the tool's defaults
_VARIANT = re.compile(r"(base|fused)(?:_chunk(\d+))?|chunk(\d+)")


def parse(name: str) -> Tuple[bool, int]:
    """(fused, lane_chunks) of a variant name; raises ValueError for a
    name outside the port's part of the tool's grammar."""
    m = _VARIANT.fullmatch(name)
    if not m:
        raise ValueError(f"unknown variant {name}")
    return m.group(1) == "fused", int(m.group(2) or m.group(3) or 1)


def measure(name: str, tree: tree_lib.GameTree,
            packed: stepping.PackedTables, net: torch.nn.Module, batch: int,
            iters: int, card: Dict) -> Dict:
    """One variant's row; raises where the lanes collapse."""
    fused, chunks = parse(name)
    device = tree.device
    generator = torch.Generator(device=device).manual_seed(1)
    rollout = bench.rollout_fn(tree, packed, net, batch, generator,
                               "on" if fused else "off",
                               lane_chunks=chunks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(bench.WARM_ROLLOUTS):
        traj = rollout()
    weights = bench.signature_weights(traj.num_half_steps, device)
    acc = torch.zeros((), device=device)
    min_std = torch.full((), 1e9, device=device)
    k1, k2 = fused_turn.fused_turn.launches, lookup.lookup.launches
    bench.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        traj = rollout()
        total, std = bench.measured(traj, weights)
        acc += total
        min_std = torch.minimum(min_std, std)
    min_std, acc = float(min_std), float(acc)
    dt = time.perf_counter() - t0
    if not min_std > 0.0:
        raise AssertionError(f"{name}: lane collapse (an episode "
                             "signature's std is 0)")
    mean_return = acc / (batch * iters)
    if abs(mean_return) > 1.0:
        print(f"# {name}: COMPUTED GARBAGE (mean return {mean_return:.3e} "
              "outside [-1, 1]); throughput reported for diagnosis only",
              flush=True)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return {"variant": name,
            "half_steps_per_s": traj.num_half_steps * batch * iters / dt,
            "dt_s": dt, "mean_return": mean_return, "lane_chunks": chunks,
            "k1_per_rollout": (fused_turn.fused_turn.launches - k1) / iters,
            "k2_per_rollout": (lookup.lookup.launches - k2) / iters,
            "peak_mem_gib": peak, **card}


def ratios(rates: Dict[str, float]) -> List[str]:
    """The tool's summary: each variant's rate over ``base``'s."""
    if "base" not in rates:
        return []
    return [f"# {k}: {v / rates['base']:.3f}x base"
            for k, v in rates.items() if k != "base"]


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parses ``argv`` (default: the command line), prints the rows and
    the ratios, and returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--variants", default="base,fused")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    names = args.variants.split(",")
    for name in names:  # before any work
        _, chunks = parse(name)
        if chunks < 1 or args.batch % chunks:
            raise ValueError(f"{name}: {args.batch} lanes do not split "
                             f"into {chunks} chunks")
    device = bench.setup(args.cpu, "rollout_probe")
    tree = tree_lib.generate_tree(bench.TREE_CONFIG, seed=0, device=device)
    packed = stepping.make_packed_tables(tree)
    net = bench.actor_net(device)
    card = bench.card(device)
    rows, rates = [], {}
    for name in names:
        row = measure(name, tree, packed, net, args.batch, args.iters,
                      card)
        rows.append(row)
        rates[name] = row["half_steps_per_s"]
        print(json.dumps(row), flush=True)
    for line in ratios(rates):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
