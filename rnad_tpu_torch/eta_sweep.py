"""The reference's eta sweep on the port (the counterpart of
``examples/eta_sweep.py``, with the same options and defaults).

Generates the small stochastic demo tree (A = 3, two chance outcomes,
stochastic depth up to 4, seed ``--seed``), saves it as ``small_tree``,
then trains one R-NaD run per regularization coefficient eta in {0, 0.2,
0.5, 1}, every run after the first starting from the first run's initial
network.  eta = 0 is plain policy gradient.  Each run lives in
``saved_runs/<prefix>-eta=<eta>/`` under the working directory with its
NashConv per update in ``metrics.jsonl``; the last log line of a run is
``eta=<eta> final nashconv: <value>``.  It runs on the card unless
``--cpu`` asks for the CPU; the depth-1 float32 MLP rolls out through
kernel K1 there, and each learner step regathers its observations through
kernel K2.

    python -m rnad_tpu_torch.eta_sweep --seed 0 --name eta-s0
    python -m rnad_tpu_torch.eta_sweep --cpu --bounds 1 --delta-m 2

``--load-tree NAME`` sweeps on a tree of the tree store (``saved_trees/``,
``rnad_tpu``'s format) instead, and the ``--net*`` options pick another
net, as in ``examples/eta_sweep.py``.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional, Sequence

from .config import NetConfig, RNaDConfig, ShapingRule, TreeConfig
from .env import tree as tree_lib
from .learn.rnad import RNaD
from .utils import checkpoint

# the reference's demo tree (its main.py)
DEMO_TREE = TreeConfig(
    max_actions=3, max_transitions=2, transition_threshold=0.3,
    depth_bound=4,
    depth_bound_rule=ShapingRule(delta=-1, stochastic_delta=-2,
                                 stochastic_prob=0.5),
    desc="3x3 stochastic tree, with depth up to 4")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--bounds", type=int, default=64)
    parser.add_argument("--delta-m", type=int, default=100)
    parser.add_argument("--etas", type=float, nargs="+",
                        default=[0.0, 0.2, 0.5, 1.0])
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--gamma-avg", type=float, default=0.01)
    parser.add_argument("--load-tree", default=None,
                        help="sweep on a saved tree instead of generating "
                             "the demo tree")
    parser.add_argument("--net", choices=["MLP", "ConvNet", "EquiNet"],
                        default="MLP")
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--net-depth", type=int, default=1)
    parser.add_argument("--channels", type=int, default=16)
    parser.add_argument("--solver-iters", type=int, default=0)
    parser.add_argument("--solver-prime", action="store_true")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--name", default=None,
                        help="run-directory prefix (default: a timestamp)")
    parser.add_argument("--expl-mod", type=int, default=1)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("--wandb", action="store_true")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[RNaD]:
    """Parses ``argv`` (default: the command line), runs the sweep and
    returns its trainers, one an eta."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = "cpu" if args.cpu else "cuda"

    if args.load_tree:
        tree = checkpoint.load_tree(args.load_tree, device=device)
    else:
        tree = tree_lib.generate_tree(DEMO_TREE, seed=args.seed, device="cpu")
        tree_lib.assert_index_is_tree(tree)
        checkpoint.save_tree(tree, "small_tree", desc=DEMO_TREE.desc,
                             config_json=DEMO_TREE.to_json())
        tree = tree.to(device)
    logging.info("tree: size=%d depth=%d hash=%d", tree.size, tree.max_depth,
                 tree.hash)

    prefix = args.name or str(int(time.time()))
    trials = []
    for idx, eta in enumerate(args.etas):
        same_init = (None if idx == 0
                     else f"{prefix}-eta={args.etas[0]}")
        cfg = RNaDConfig(
            batch_size=args.batch_size, eta=eta,
            bounds=(args.bounds,), delta_m=(args.delta_m,),
            lr=args.lr, gamma_averaging=args.gamma_avg, logit_clip=2.0)
        trial = RNaD(
            tree, cfg,
            NetConfig(type=args.net, max_actions=tree.max_actions,
                      width=args.width, depth=args.net_depth,
                      channels=args.channels,
                      solver_iters=args.solver_iters,
                      solver_prime=args.solver_prime,
                      compute_dtype=args.compute_dtype),
            directory_name=f"{prefix}-eta={eta}",
            seed=args.seed,
            use_same_init_net_as=same_init,
            use_wandb=args.wandb, device=device)
        trial.run(log_mod=10, expl_mod=args.expl_mod, checkpoint_mod=1000)
        logging.info("eta=%s final nashconv: %f", eta, trial.final_eval())
        trials.append(trial)
    return trials


if __name__ == "__main__":
    main()
