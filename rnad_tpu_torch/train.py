"""Training entry point of the port (the counterpart of
``examples/train.py``, with the same options).

Generates (or loads) a game tree, then runs R-NaD with either the demo
hyperparameters or the DeepNash paper schedule, each overridable by flag.
The run lives in ``saved_runs/<name>/`` under the working directory and
the tree in ``saved_trees/``; running again with the same ``--name``
resumes the run from its latest checkpoint.  It runs on the card unless
``--cpu`` asks for the CPU.

Data parallelism (``parallel/``): ``--data-parallel`` alone trains as a
world of the ranks this process spans, one rank on one device; with
``--coordinator host:port --num-processes N --process-id i`` each of N
processes is one rank, on ``cuda:(i % device_count)`` over NCCL, or over
gloo under ``--cpu``.  Every rank takes its slice of the lanes of one global
noise stream, and only rank 0 writes the tree and the run store.  Every
configuration runs there: a ConvNet's BatchNorm normalizes over the global
batch, and the buffered step (``--n-batches-per-buffer``, ``--buffer-mod``)
samples global lanes from the ranks' buffers (``parallel/runtime.py``).

Examples:
  python -m rnad_tpu_torch.train --demo                 # reference demo run
  python -m rnad_tpu_torch.train --cpu --demo --tree-depth 3 --max-updates 1
  python -m rnad_tpu_torch.train --native-gen --max-actions 5 \\
      --tree-depth 6 --transition-threshold 0.25 --stochastic-depth \\
      --stochastic-prob 0.55 --net EquiNet --channels 64 --net-depth 2 \\
      --solver-iters 128 --solver-prime --compute-dtype bfloat16 \\
      --batch-size 32768 --eta 0.5 --lr 5e-5 --lr-schedule cosine \\
      --lr-decay-steps 18600 --lr-final-fraction 0.1 --gamma-avg 0.001 \\
      --policy-warmup 1500 --bounds 10 45 --delta-m 1500 1800 \\
      --name flagship3                                  # flagship-3
  python -m rnad_tpu_torch.train --native-gen --max-actions 5 \\
      --tree-depth 6 --transition-threshold 0.25 --stochastic-depth \\
      --stochastic-prob 0.55 --batch-size 32768 --lr 5e-4 --bounds 2 \\
      --delta-m 300 --n-batches-per-buffer 4 --buffer-mod 2 \\
      --name r5-offpol-32k                              # buffered MLP
  python -m rnad_tpu_torch.train --demo --obs-lift 8 --obs-noise-sigma \\
      0.15 --net ConvNet --channels 16 --net-depth 2 \\
      --name r5-noisy-conv                              # noisy lift
  python -m rnad_tpu_torch.train --cpu --demo --tree-depth 3 \\
      --coordinator localhost:29500 --num-processes 2 --process-id 0 &
  python -m rnad_tpu_torch.train --cpu --demo --tree-depth 3 \\
      --coordinator localhost:29500 --num-processes 2 --process-id 1
                                                        # two ranks, gloo

The lift's fixed (mix, bias) pair is drawn from ``--obs-lift-seed`` by the
port's own generator, so it differs from ``examples/train.py``'s for the
same seed (``ops/obs_transform.py``).
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import torch.distributed as dist

from .config import (NetConfig, ObsTransformConfig, RNaDConfig, ShapingRule,
                     TreeConfig)
from .env import tree as tree_lib
from .learn import rnad as rnad_lib
from .parallel import runtime
from .parallel.mesh import DataGroup
from .utils import checkpoint

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=None, help="run directory name")
    p.add_argument("--seed", type=int, default=0)
    # tree
    p.add_argument("--load-tree", default=None)
    p.add_argument("--load-reference-tree", default=None, metavar="PATH",
                   help="import a reference-format tree.tar (torch.save of "
                        "the saved_keys dict) and train on it")
    p.add_argument("--max-actions", type=int, default=3)
    p.add_argument("--max-transitions", type=int, default=2)
    p.add_argument("--tree-depth", type=int, default=4)
    p.add_argument("--transition-threshold", type=float, default=0.3)
    p.add_argument("--stochastic-depth", action="store_true",
                   help="depth rule -1 with --stochastic-prob extra -2 "
                        "(reference demo)")
    p.add_argument("--stochastic-prob", type=float, default=0.5,
                   help="probability of the extra -2 depth decrement when "
                        "--stochastic-depth is set")
    p.add_argument("--native-gen", action="store_true",
                   help="use the C++ generator (fast for big trees)")
    # training
    p.add_argument("--demo", action="store_true",
                   help="reference main.py hyperparameters")
    p.add_argument("--eta", type=float, default=0.2)
    p.add_argument("--batch-size", type=int, default=768)
    p.add_argument("--bounds", type=int, nargs="+", default=None,
                   help="(n, m) schedule period bounds, e.g. --bounds 30 "
                        "60 90")
    p.add_argument("--delta-m", type=int, nargs="+", default=None,
                   help="steps per update period in each bounds segment")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["constant", "cosine"],
                   help="constant or cosine decay to lr * lr-final-fraction "
                        "over --lr-decay-steps (RNaDConfig.lr_schedule)")
    p.add_argument("--lr-decay-steps", type=int, default=None)
    p.add_argument("--lr-final-fraction", type=float, default=None)
    p.add_argument("--policy-warmup", type=int, default=None,
                   help="critic-first warmup: gate the NeuRD policy loss "
                        "to zero for this many initial learner steps")
    p.add_argument("--gamma-avg", type=float, default=None,
                   help="EMA rate of the target net (gamma_averaging)")
    p.add_argument("--fuse-net-passes", default=None,
                   choices=["off", "heads", "frozen", "all", "auto"],
                   help="net-pass strategy (RNaDConfig.fuse_net_passes): "
                        "'frozen' packs the 3 frozen nets of a depth-1 MLP "
                        "into one matmul pair, 'all' the learner too")
    p.add_argument("--frozen-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="dtype of the 3 frozen-net learner forwards")
    p.add_argument("--learner-layout", default=None,
                   choices=["bma", "amb", "auto"],
                   help="layout of the learner's policies, v-trace and "
                        "losses: (T, B, A) 'bma' or batch-minor (T, A, B) "
                        "'amb' (bitwise the same values); 'auto' is 'bma'")
    p.add_argument("--flat-optimizer", action="store_true", default=None,
                   help="clip + Adam + EMA on one raveled vector (bitwise "
                        "the per-leaf update; constant lr and float32 "
                        "weights only, else per leaf)")
    p.add_argument("--vtrace-mode", default=None,
                   choices=["scan", "associative", "auto"],
                   help="v-trace time recursion")
    p.add_argument("--net", choices=["MLP", "ConvNet", "EquiNet"],
                   default="MLP")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--net-depth", type=int, default=1,
                   help="MLP hidden / ConvNet residual / EquiNet layers")
    p.add_argument("--channels", type=int, default=16,
                   help="ConvNet / EquiNet only")
    p.add_argument("--solver-iters", type=int, default=0,
                   help="EquiNet only: RM+ solver-iterate input features")
    p.add_argument("--solver-prime", action="store_true",
                   help="EquiNet only: primed heads")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--reg-anchor", default=None,
                   choices=["target", "best", "fixed"],
                   help="regularization rotation at update boundaries "
                        "(RNaDConfig.reg_anchor)")
    p.add_argument("--obs-lift", type=int, default=None, metavar="C",
                   help="noisy observation transform with C lifted channels")
    p.add_argument("--obs-noise-sigma", type=float, default=0.1)
    p.add_argument("--obs-lift-bias", type=float, default=1.0)
    p.add_argument("--obs-lift-seed", type=int, default=0)
    p.add_argument("--n-batches-per-buffer", type=int, default=1,
                   help="replay-buffer capacity in rollout batches; 1 = "
                        "on-policy")
    p.add_argument("--buffer-mod", type=int, default=1,
                   help="roll out a fresh batch every this many learner "
                        "steps")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard lanes over all local devices")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--max-updates", type=int, default=10**6)
    p.add_argument("--checkpoint-mod", type=int, default=1000)
    p.add_argument("--expl-mod", type=int, default=1)
    p.add_argument("--log-mod", type=int, default=20)
    p.add_argument("--wandb", action="store_true")
    return p


def _tree(args: argparse.Namespace, device,
          writes: bool = True) -> tree_lib.GameTree:
    if args.load_reference_tree:
        return checkpoint.load_reference_tree(args.load_reference_tree,
                                              device)
    if args.load_tree:
        return checkpoint.load_tree(args.load_tree, device=device)
    depth_rule = (ShapingRule(delta=-1, stochastic_delta=-2,
                              stochastic_prob=args.stochastic_prob)
                  if args.stochastic_depth else ShapingRule(delta=-1))
    tree_cfg = TreeConfig(
        max_actions=args.max_actions, max_transitions=args.max_transitions,
        depth_bound=args.tree_depth,
        transition_threshold=args.transition_threshold,
        depth_bound_rule=depth_rule)
    gen = (tree_lib.generate_tree_native if args.native_gen
           else tree_lib.generate_tree)
    t0 = time.perf_counter()
    tree = gen(tree_cfg, seed=args.seed, device="cpu")
    log.info("tree generated in %.3f s (%s)", time.perf_counter() - t0,
             "native" if args.native_gen else "numpy")
    tree_lib.assert_index_is_tree(tree)
    if writes:  # the tree store is shared by the ranks
        t0 = time.perf_counter()
        checkpoint.save_tree(tree, args.name or "train_tree",
                             config_json=tree_cfg.to_json())
        log.info("tree stored in %.3f s", time.perf_counter() - t0)
    return tree.to(device)


def main(argv: Optional[Sequence[str]] = None) -> rnad_lib.RNaD:
    """Parses ``argv`` (default: the command line), trains, logs the final
    NashConv and returns the trainer.  A data-parallel run leaves its
    process group before returning."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = "cpu" if args.cpu else "cuda"
    if not (args.data_parallel or (args.num_processes or 1) > 1):
        return _train(args, device)
    runtime.initialize_distributed(args.coordinator, args.num_processes,
                                   args.process_id, device_type=device)
    try:
        group = runtime.data_group(device)
        log.info("data-parallel: rank %d/%d on %s over %s", group.rank,
                 group.world, group.device, dist.get_backend())
        return _train(args, group.device, group)
    finally:
        runtime.shutdown()


def _config(args: argparse.Namespace) -> RNaDConfig:
    buffer_kw = dict(n_batches_per_buffer=args.n_batches_per_buffer,
                     buffer_mod=args.buffer_mod)
    if args.fuse_net_passes is not None:
        buffer_kw["fuse_net_passes"] = args.fuse_net_passes
    if args.obs_lift is not None:
        buffer_kw["obs_transform"] = ObsTransformConfig(
            kind="lift", channels=args.obs_lift,
            sigma=args.obs_noise_sigma, bias_scale=args.obs_lift_bias,
            seed=args.obs_lift_seed)
    if args.demo:
        return RNaDConfig(batch_size=512, eta=args.eta, bounds=(64,),
                          delta_m=(100,), lr=1e-3, gamma_averaging=0.01,
                          logit_clip=2.0, **buffer_kw)
    # DeepNash paper schedule, overridable per flag
    override_kw = {k: v for k, v in dict(
        bounds=tuple(args.bounds) if args.bounds else None,
        delta_m=tuple(args.delta_m) if args.delta_m else None,
        lr=args.lr, lr_schedule=args.lr_schedule,
        lr_decay_steps=args.lr_decay_steps,
        lr_final_fraction=args.lr_final_fraction,
        policy_warmup_steps=args.policy_warmup,
        gamma_averaging=args.gamma_avg,
        frozen_net_dtype=args.frozen_dtype,
        learner_layout=args.learner_layout,
        flat_optimizer=args.flat_optimizer,
        vtrace_mode=args.vtrace_mode,
        reg_anchor=args.reg_anchor).items() if v is not None}
    return RNaDConfig(batch_size=args.batch_size, eta=args.eta,
                      **buffer_kw, **override_kw)


def _train(args: argparse.Namespace, device,
           group: Optional[DataGroup] = None) -> rnad_lib.RNaD:
    cfg = _config(args)
    if group is not None:  # raises before the tree store is written
        runtime.check_data_parallel(cfg, group)
    tree = _tree(args, device, group is None or group.rank == 0)
    log.info("tree: size=%d depth=%d hash=%d", tree.size, tree.max_depth,
             tree.hash)
    net_cfg = NetConfig(type=args.net, max_actions=tree.max_actions,
                        width=args.width, depth=args.net_depth,
                        channels=args.channels,
                        solver_iters=args.solver_iters,
                        solver_prime=args.solver_prime,
                        compute_dtype=args.compute_dtype)
    trainer = rnad_lib.RNaD(tree, cfg, net_cfg, directory_name=args.name,
                            seed=args.seed, use_wandb=args.wandb,
                            device=device, group=group)
    trainer.run(max_updates=args.max_updates,
                checkpoint_mod=args.checkpoint_mod,
                expl_mod=args.expl_mod, log_mod=args.log_mod)
    log.info("final nashconv: %f", trainer.final_eval())
    return trainer


if __name__ == "__main__":
    main()
