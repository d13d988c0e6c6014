"""One rank of a multi-process data-parallel run (the counterpart of
``tools/mp_worker.py``).

Each process runs this program: it joins the group through
``parallel.runtime.initialize_distributed`` (gloo by default, so that
ranks may share one card), builds the tree and the trainer from the shared
seed, and runs the global-stream fused step (``runtime.py``) with its
slice of the lanes; the only communication is ``torch.distributed``'s.
Every rank prints one JSON line: its losses, the parameter checksum after
each step (the sum of |w| over the learner's weights), a SHA-256 of the
weights' bytes (equal on every rank when the weights are replicated) and
the wall time of each step; rank 0 also writes it to ``--out``.

The train task (default) optionally saves its step-0 trajectory lanes
(``--traj-out DIR``: ``DIR/rank<i>.npz``), checkpoints at its end
(``--save``) or resumes (``--resume``) in ``--run-dir``, whatever the rank
count that saved it.  ``--task nashconv`` runs the node-sharded NashConv
(``metrics/nashconv_shard.py``) of a stored tree (``--tree-dir``) under the
joint policy in ``--policy`` (an (S, 2A) ``.npy``) and writes rank 0's
per-node values to ``--out`` (``.npz``).

Spawned by ``rnad_tpu_torch/multiprocess_check.py``:

    python -m rnad_tpu_torch.mp_worker --process-id I --num-processes N \\
        --port P [--device cpu|cuda] [--backend gloo|nccl] [--steps S]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .config import NetConfig, RNaDConfig, TreeConfig
from .env import tree as tree_lib
from .learn import rnad as rnad_lib
from .metrics import nashconv_shard
from .parallel import runtime
from .utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--task", choices=["train", "nashconv"], default="train")
    p.add_argument("--out", default=None,
                   help="rank 0's result (JSON, or .npz for nashconv)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--tree-depth", type=int, default=3)
    p.add_argument("--tree-dir", default=None,
                   help="a stored tree (tree.npz, meta.json) in place of "
                        "the generated depth --tree-depth one")
    p.add_argument("--traj-out", default=None)
    p.add_argument("--policy", default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--save", action="store_true")
    p.add_argument("--resume", action="store_true")
    return p


def _tree(args, device):
    if args.tree_dir:
        root, name = os.path.split(os.path.normpath(args.tree_dir))
        return checkpoint.load_tree(name, root, device=device)
    return tree_lib.generate_tree(
        TreeConfig(max_actions=3, max_transitions=2,
                   depth_bound=args.tree_depth), seed=1, device=device)


def param_digest(net: torch.nn.Module) -> str:
    """SHA-256 of the weights' bytes, in ``parameters()`` order."""
    h = hashlib.sha256()
    for p in net.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def checksum(net: torch.nn.Module) -> float:
    return float(sum(p.detach().abs().sum() for p in net.parameters()))


def train(args, group) -> dict:
    tree = _tree(args, group.device)
    cfg = RNaDConfig(batch_size=args.batch_size, eta=0.2, bounds=(10,),
                     delta_m=(100,), lr=1e-3, gamma_averaging=0.01,
                     logit_clip=2.0)
    net_cfg = NetConfig(type="MLP", max_actions=tree.max_actions,
                        width=args.width)
    with tempfile.TemporaryDirectory() as scratch:
        root, name = os.path.split(os.path.normpath(args.run_dir or
                                                    os.path.join(scratch,
                                                                 "run")))
        trainer = rnad_lib.RNaD(tree, cfg, net_cfg, directory_name=name,
                                runs_root=root, seed=args.seed, group=group)
        if args.resume and trainer.store.latest() is None:
            raise RuntimeError(f"no checkpoint to resume in {args.run_dir}")
        trainer.initialize()
        state = trainer.state
        if args.traj_out:  # the rollout of step 0, generator restored
            before = state.generator.get_state()
            traj = runtime.make_sharded_rollout(trainer.tree, trainer.packed,
                                                cfg, group)(state)
            state.generator.set_state(before)
            os.makedirs(args.traj_out, exist_ok=True)
            np.savez(os.path.join(args.traj_out, f"rank{group.rank}.npz"),
                     **{k: getattr(traj, k).cpu().numpy() for k in
                        ("indices", "policy", "actions", "rewards")})
        sync = (torch.cuda.synchronize if group.device.type == "cuda"
                else lambda: None)
        losses, checksums, step_s = [], [], []
        for _ in range(args.steps):
            sync()
            t0 = time.perf_counter()
            _, metrics = trainer.train_step(state, 0.5)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(runtime.host_value(metrics["loss"]))
            checksums.append(checksum(state.net))
        if args.save:
            trainer.m, trainer.n = 0, state.total_steps
            trainer.save_checkpoint()
            group.barrier()  # the checkpoint is written before any rank exits
    return {"losses": losses, "param_checksum": checksums[-1],
            "checksums": checksums, "param_digest": param_digest(state.net),
            "total_steps": state.total_steps, "step_s": step_s}


def nashconv(args, group) -> dict:
    tree = _tree(args, "cpu")
    joint = torch.from_numpy(np.load(args.policy))
    t0 = time.perf_counter()
    result = nashconv_shard.nashconv_sharded(tree, joint, group)
    if group.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if args.out and group.rank == 0:
        np.savez(args.out, row_best=result.row_best.cpu().numpy(),
                 col_best=result.col_best.cpu().numpy())
    return {"nashconv": float(result.nashconv()), "seconds": seconds}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    torch.set_num_threads(1)  # ranks may share the host's cores
    runtime.initialize_distributed(f"localhost:{args.port}",
                                   args.num_processes, args.process_id,
                                   args.backend, args.device)
    try:
        group = runtime.data_group(args.device, args.backend)
        result = (train if args.task == "train" else nashconv)(args, group)
    finally:
        runtime.shutdown()
    result.update(process_id=group.rank, num_processes=group.world,
                  device=str(group.device), backend=args.backend)
    print(json.dumps(result), flush=True)
    if args.out and group.rank == 0 and args.task == "train":
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    sys.exit(main())
