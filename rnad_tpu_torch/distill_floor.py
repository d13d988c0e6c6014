"""Architecture floor on a stored tree: distill the exact solution into a
net (the counterpart of ``tools/distill_floor.py``, with the same options,
net specs and JSON lines).

For a tree of the tree store (``saved_trees/`` under the working
directory), trains each requested net by supervised regression onto the
generator's exact per-node NE policies and values
(``learn/supervised.py``) and prints the distilled policy's exact
NashConv: no R-NaD run with the same net can be expected to land below it.
It runs on the card unless ``--cpu`` asks for the CPU.

    python -m rnad_tpu_torch.distill_floor --tree flagship3 \\
        --net EquiNet:64x2s128p --steps 3000 --node-batch 8192
    python -m rnad_tpu_torch.distill_floor --cpu --tree small_tree \\
        --net MLP:256 --steps 2000 --node-batch 0

Net specs: ``MLP:<width>[x<depth>]``, ``ConvNet:<channels>x<depth>``
(without BatchNorm) or ``EquiNet:<channels>x<depth>[s<solver_iters>[p]]``
(p: primed heads, whose step-0 policy is the RM+ solve); ``RM+[:<iters>]``
scores the net-free RM+ skyline (the RM+ solve of each node's observed
matrix, kernel K3 on the card; no training).  The first line describes the
tree, then one JSON line a net.  Each net starts from ``--seed``'s
initialization (the port's generator, not rnad_tpu's) and draws its
minibatches from a generator seeded ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import torch

from .config import NetConfig
from .env import solver_device
from .learn import supervised
from .metrics import nashconv as nashconv_lib
from .models import nets
from .utils import checkpoint


def parse_net(spec: str, max_actions: int) -> NetConfig:
    """The NetConfig of a net spec (module docstring)."""
    kind, _, shape = spec.partition(":")
    if kind == "MLP":
        w, _, d = (shape or "256").partition("x")
        return NetConfig(type="MLP", max_actions=max_actions,
                         width=int(w), depth=int(d or 1))
    if kind == "ConvNet":
        ch, _, depth = (shape or "16x2").partition("x")
        return NetConfig(type="ConvNet", max_actions=max_actions,
                         channels=int(ch), depth=int(depth or 2),
                         batch_norm=False)
    if kind == "EquiNet":
        ch, _, depth = (shape or "128x4").partition("x")
        depth, _, solver = (depth or "4").partition("s")
        return NetConfig(type="EquiNet", max_actions=max_actions,
                         channels=int(ch), depth=int(depth or 4),
                         solver_iters=int(solver.rstrip("p") or 0),
                         solver_prime=solver.endswith("p"))
    raise SystemExit(f"unknown net spec {spec!r} "
                     "(MLP:<w>[x<d>] | ConvNet:<c>x<d> | EquiNet:<c>x<d>)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default="recent")
    ap.add_argument("--net", action="append", default=[],
                    help="a net spec (module docstring); repeatable")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--node-batch", type=int, default=65536,
                    help="node-seat rows per step (0 = full batch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parses ``argv`` (default: the command line), prints the JSON lines
    and returns them."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    tree = checkpoint.load_tree(args.tree, device=device)
    lines = [{"tree": args.tree, "size": tree.size,
              "depth": tree.max_depth}]
    print(json.dumps(lines[-1]), flush=True)
    for spec in args.net or ["MLP:256"]:
        t0 = time.time()
        if spec.startswith("RM+"):
            iters = int(spec.partition(":")[2] or 2000)
            joint = solver_device.joint_policy_rmplus(tree, iters=iters)
            result = nashconv_lib.nashconv_root(tree, joint)
            line = {"net": spec,
                    "floor_nashconv": round(float(result.nashconv()), 6),
                    "iters": iters}
        else:
            net = nets.build_net(parse_net(spec, tree.max_actions),
                                 torch.Generator().manual_seed(args.seed))
            gen = torch.Generator(device=device).manual_seed(args.seed)
            _, metrics = supervised.train_oracle_net(
                tree, net.to(device), steps=args.steps, lr=args.lr,
                node_batch=args.node_batch or None, generator=gen)
            line = {"net": spec,
                    "floor_nashconv": round(metrics["nashconv"], 6),
                    "final_loss": round(metrics["final_loss"], 6),
                    "steps": args.steps, "node_batch": args.node_batch}
        line["seconds"] = round(time.time() - t0, 1)
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
