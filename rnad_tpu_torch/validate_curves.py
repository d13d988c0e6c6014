"""The port's half of ``tools/validate_vs_reference.py``: NashConv per
update of a run that ``rnad_tpu`` makes on the same tree from the same
initial weights with the same hyperparameters.

The JAX tool drives the reference implementation and ``rnad_tpu``
(``run_ours``) side by side.  Here the port takes ``rnad_tpu``'s place
of the reference, and the two halves run apart, because the card's
machine has no JAX: this module runs the port (on the card unless
``--cpu`` asks for the CPU), and ``docs/port_runs/curves/
validate_vs_rnad_tpu.py`` runs ``rnad_tpu`` on the CPU through the JAX
tool's own ``run_ours`` and compares the two.

    python -m rnad_tpu_torch.validate_curves --seed 0 --out DIR

It generates the tool's tree (A = 3, two chance outcomes, threshold 0.3,
depth ``--depth``, seed ``--seed``; or loads a reference tree), draws the
initial width-256 MLP from ``torch.Generator().manual_seed(seed)`` on the
CPU (so every device starts from the same weights) and writes it as
``<out>/<name>.init.npz`` in flax's layout (``nets.params_to_flax``), then
runs the tool's loop: ``--updates`` update periods of ``--delta-m`` fused
steps at ``--batch-size`` lanes, the alpha schedule within a period, the
regularization nets rotated after it, and the target's NashConv before the
first step and after each period.  It writes ``<out>/<name>.port.json``:
the tree's hash, size and depth, the options, the curve, the wall seconds,
the device (``nvidia-smi``'s name and power limit on the card) and the
launches a step of kernels K1 and K2 (zero on the CPU, where the wrappers
run their plain versions).  The options and defaults are the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import RNaDConfig, ShapingRule, TreeConfig
from .env import tree as tree_lib
from .learn import rnad
from .models import nets
from .ops import fused_turn, lookup, stepping
from .utils import checkpoint

WIDTH = 256  # the reference's MLP


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--updates", type=int, default=8)
    parser.add_argument("--delta-m", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--eta", type=float, default=0.2)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--gamma-avg", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--depth", type=int, default=3)
    parser.add_argument("--stochastic-depth", action="store_true",
                        help="depth rule -1 with 50%% chance of -3 total -- "
                             "the reference demo tree shape")
    parser.add_argument("--reference-tree", default=None, metavar="PATH",
                        help="run on a reference-authored tree.tar instead "
                             "of generating one (utils/checkpoint.py::"
                             "load_reference_tree)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("--out", default=".",
                        help="directory of the .init.npz and .port.json")
    parser.add_argument("--name", default=None,
                        help="file prefix (default curves-s<seed>)")
    return parser


def tree_config(depth: int, stochastic_depth: bool) -> TreeConfig:
    """The JAX tool's tree config (tools/validate_vs_reference.py:230-236)."""
    rule = (ShapingRule(delta=-1, stochastic_delta=-2, stochastic_prob=0.5)
            if stochastic_depth else ShapingRule(delta=-1))
    return TreeConfig(max_actions=3, max_transitions=2,
                      transition_threshold=0.3, depth_bound=depth,
                      depth_bound_rule=rule)


def initial_net(max_actions: int, seed: int) -> nets.MLP:
    """The run's initial MLP, drawn on the CPU from the seed."""
    return nets.MLP(max_actions, WIDTH,
                    generator=torch.Generator().manual_seed(seed))


def save_flax_npz(net: nets.MLP, path: str) -> None:
    """``net``'s parameters in flax's layout as ``<layer>/<leaf>`` arrays
    (``docs/port_runs/curves/validate_vs_rnad_tpu.py::load_params`` reads
    them back)."""
    flat = {f"{layer}/{leaf}": a for layer, leaves in
            nets.params_to_flax(net).items() for leaf, a in leaves.items()}
    np.savez(path, **flat)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run_port(tree: tree_lib.GameTree, net: nets.MLP, updates: int,
             delta_m: int, batch_size: int, eta: float, lr: float,
             gamma_avg: float, seed: int):
    """The JAX tool's ``run_ours`` on the port, on the tree's device:
    returns (the target's NashConv before the first step and after each
    update period, K1 launches, K2 launches over the train steps)."""
    cfg = RNaDConfig(batch_size=batch_size, eta=eta, bounds=(updates,),
                     delta_m=(delta_m,), lr=lr, gamma_averaging=gamma_avg,
                     logit_clip=2.0)
    packed = stepping.make_packed_tables(tree)
    generator = torch.Generator(device=tree.device).manual_seed(seed)
    state = rnad.init_train_state(net.to(tree.device), generator)
    train_step = rnad.make_train_step(tree, packed, cfg)
    nashconv = lambda: float(rnad.nashconv(tree, state.net_target)
                             .nashconv())
    curve = [nashconv()]
    k1 = k2 = 0
    for m in range(updates):
        before = fused_turn.fused_turn.launches, lookup.lookup.launches
        for n in range(delta_m):
            state, _ = train_step(state, rnad.alpha_schedule(n, delta_m))
        k1 += fused_turn.fused_turn.launches - before[0]
        k2 += lookup.lookup.launches - before[1]
        state = rnad.rotate_regularization_nets(state)
        curve.append(nashconv())
        logging.info("port m=%d: nashconv=%.4f", m + 1, curve[-1])
    return curve, k1, k2


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parses ``argv`` (default: the command line), runs the port's half
    and returns the record it wrote to ``<out>/<name>.port.json``."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("validate_curves runs on a CUDA card; pass --cpu "
                         "to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.reference_tree:
        tree = checkpoint.load_reference_tree(args.reference_tree,
                                              device=device)
    else:
        tree = tree_lib.generate_tree(
            tree_config(args.depth, args.stochastic_depth), seed=args.seed,
            device=device)
    logging.info("tree: size=%d depth=%d hash=%d", tree.size, tree.max_depth,
                 tree.hash)
    name = args.name or f"curves-s{args.seed}"
    os.makedirs(args.out, exist_ok=True)
    net = initial_net(tree.max_actions, args.seed)
    save_flax_npz(net, os.path.join(args.out, f"{name}.init.npz"))

    t0 = time.perf_counter()
    curve, k1, k2 = run_port(tree, net, args.updates, args.delta_m,
                             args.batch_size, args.eta, args.lr,
                             args.gamma_avg, args.seed)
    wall = time.perf_counter() - t0
    steps = args.updates * args.delta_m
    options = {k: v for k, v in vars(args).items()
               if k not in ("cpu", "out", "name")}
    record = {"name": name,
              "tree": {"hash": int(tree.hash), "size": int(tree.size),
                       "max_depth": int(tree.max_depth)},
              "options": options, "init": f"{name}.init.npz",
              "curve": curve, "wall_s": wall, "device": card_name(device),
              "torch": torch.__version__, "steps": steps,
              "k1_per_step": k1 / steps, "k2_per_step": k2 / steps}
    with open(os.path.join(args.out, f"{name}.port.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    logging.info("port: %d steps in %.1f s on %s; K1 %.6g and K2 %.6g "
                 "launches a step", steps, wall, record["device"],
                 record["k1_per_step"], record["k2_per_step"])
    return record


if __name__ == "__main__":
    main()
