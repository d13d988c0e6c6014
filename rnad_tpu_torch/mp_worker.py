"""One rank of a multi-process data-parallel run (the counterpart of
``tools/mp_worker.py``).

Each process runs this program: it joins the group through
``parallel.runtime.initialize_distributed`` (on the card over NCCL unless
``--cpu`` or ``--backend`` says otherwise; ranks that share one card need
``--backend gloo``, since NCCL refuses them), builds the tree and the
trainer from the shared seed, and runs the global-stream fused step
(``runtime.py``) with its slice of the lanes, or with
``--n-batches-per-buffer`` / ``--buffer-mod`` the buffered step from a
fresh buffer; the only communication is ``torch.distributed``'s.  The net
is an MLP (``--width``) or, with ``--net``, the EquiNet or the ConvNet
(``--channels``, ``--net-depth``), on raw observations or under the lift
(``--obs-lift C``).  Every rank prints one JSON line: its losses, the
parameter checksum after each step (the sum of |w| over the learner's
weights), a SHA-256 of the learner's state dict (weights and BatchNorm
statistics; equal on every rank when they are replicated), the wall time
of each step and the kernels' launches over the steps (0 on the CPU,
where the wrappers run their plain versions); rank 0 also writes it to
``--out``.

The train task (default) optionally saves trajectory lanes (``--traj-out
DIR``: ``DIR/rank<i>.npz``): the on-policy step's step-0 rollout, or the
buffered step's collated batch of every step (stacked on a leading step
axis).  It checkpoints at its end (``--save``) or resumes (``--resume``)
in ``--run-dir``, whatever the rank count that saved it.  ``--task
nashconv`` runs the node-sharded NashConv (``metrics/nashconv_shard.py``)
of a stored tree (``--tree-dir``) under the joint policy in ``--policy``
(an (S, 2A) ``.npy``) and writes rank 0's per-node values to ``--out``
(``.npz``).

Spawned by ``rnad_tpu_torch/multiprocess_check.py``; two ranks sharing one
card:

    python -m rnad_tpu_torch.mp_worker --process-id I --num-processes 2 \\
        --port P --backend gloo [--steps S] [--net ConvNet] ...
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

from .config import NetConfig, ObsTransformConfig, RNaDConfig, TreeConfig
from .env import tree as tree_lib
from .learn import buffer as buffer_lib
from .learn import rnad as rnad_lib
from .metrics import nashconv_shard
from .ops import fused_turn, lookup, rmplus
from .parallel import runtime
from .utils import checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--cpu", dest="device", action="store_const",
                   const="cpu", default="cuda",
                   help="run on the CPU instead of the card")
    p.add_argument("--backend", default=None,
                   help="nccl on the card, gloo on the CPU by default")
    p.add_argument("--task", choices=["train", "nashconv"], default="train")
    p.add_argument("--out", default=None,
                   help="rank 0's result (JSON, or .npz for nashconv)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--net", choices=["MLP", "ConvNet", "EquiNet"],
                   default="MLP")
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--channels", type=int, default=16,
                   help="ConvNet / EquiNet only")
    p.add_argument("--net-depth", type=int, default=1)
    p.add_argument("--obs-lift", type=int, default=None, metavar="C",
                   help="noisy observation transform with C lifted channels")
    p.add_argument("--obs-noise-sigma", type=float, default=0.1)
    p.add_argument("--n-batches-per-buffer", type=int, default=1)
    p.add_argument("--buffer-mod", type=int, default=1)
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
    """SHA-256 of the state dict's bytes (the weights and any BatchNorm
    statistics), in its order."""
    h = hashlib.sha256()
    for t in net.state_dict().values():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def checksum(net: torch.nn.Module) -> float:
    return float(sum(p.detach().abs().sum() for p in net.parameters()))


class _RecordingBuffer(buffer_lib.TrajectoryBuffer):
    """A replay buffer that keeps each collated batch it samples."""

    def __init__(self, max_size: int):
        super().__init__(max_size)
        self.samples = []

    def sample(self, *args, **kwargs):
        traj = super().sample(*args, **kwargs)
        self.samples.append(traj)
        return traj


TRAJ_FIELDS = ("indices", "policy", "actions", "rewards", "obs")


def saved_fields(traj) -> dict:
    """The trajectory's fields that ``--traj-out`` keeps, as numpy arrays:
    lanes along axis 1, the observations where the rollout stored
    them."""
    fields = {k: getattr(traj, k) for k in TRAJ_FIELDS}
    return {k: v.float().cpu().numpy() if k == "obs" else v.cpu().numpy()
            for k, v in fields.items() if v is not None}


def train(args, group) -> dict:
    tree = _tree(args, group.device)
    lift = ({} if args.obs_lift is None else dict(
        obs_transform=ObsTransformConfig(kind="lift", channels=args.obs_lift,
                                         sigma=args.obs_noise_sigma)))
    cfg = RNaDConfig(batch_size=args.batch_size, eta=0.2, bounds=(10,),
                     delta_m=(100,), lr=1e-3, gamma_averaging=0.01,
                     logit_clip=2.0,
                     n_batches_per_buffer=args.n_batches_per_buffer,
                     buffer_mod=args.buffer_mod, **lift)
    net_cfg = NetConfig(type=args.net, max_actions=tree.max_actions,
                        width=args.width, channels=args.channels,
                        depth=args.net_depth)
    on_policy = cfg.n_batches_per_buffer == 1 and cfg.buffer_mod == 1
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
        saved = None
        if args.traj_out and on_policy:  # step 0's rollout, noise restored
            before = state.generator.get_state()
            traj = runtime.make_sharded_rollout(
                trainer.tree, trainer.packed, cfg, group,
                trainer.obs_transform)(state)
            state.generator.set_state(before)
            saved = saved_fields(traj)
        buffer = _RecordingBuffer(cfg.n_batches_per_buffer)
        step = ((lambda: trainer.train_step(state, 0.5)[1]) if on_policy
                else (lambda: trainer.buffered_step(buffer, 0.5)))
        sync = (torch.cuda.synchronize if group.device.type == "cuda"
                else lambda: None)
        losses, checksums, step_s = [], [], []
        fused_turn.fused_turn.launches = lookup.lookup.launches = 0
        rmplus.rmplus.launches = 0
        for _ in range(args.steps):
            sync()
            t0 = time.perf_counter()
            metrics = step()
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(runtime.host_value(metrics["loss"]))
            checksums.append(checksum(state.net))
        launches = {"k1": fused_turn.fused_turn.launches,
                    "k2": lookup.lookup.launches,
                    "k3": rmplus.rmplus.launches}
        if args.traj_out and not on_policy:  # every step's collated lanes
            per_step = [saved_fields(t) for t in buffer.samples]
            saved = {k: np.stack([s[k] for s in per_step])
                     for k in per_step[0]}
        if saved is not None:
            os.makedirs(args.traj_out, exist_ok=True)
            np.savez(os.path.join(args.traj_out, f"rank{group.rank}.npz"),
                     **saved)
        if args.save:
            trainer.m, trainer.n = 0, state.total_steps
            trainer.save_checkpoint()
            group.barrier()  # the checkpoint is written before any rank exits
    return {"losses": losses, "param_checksum": checksums[-1],
            "checksums": checksums, "param_digest": param_digest(state.net),
            "total_steps": state.total_steps, "step_s": step_s,
            "launches": launches}


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
    backend = args.backend or runtime.default_backend(args.device)
    runtime.initialize_distributed(f"localhost:{args.port}",
                                   args.num_processes, args.process_id,
                                   backend, args.device)
    try:
        group = runtime.data_group(args.device, backend)
        result = (train if args.task == "train" else nashconv)(args, group)
    finally:
        runtime.shutdown()
    result.update(process_id=group.rank, num_processes=group.world,
                  device=str(group.device), backend=backend)
    print(json.dumps(result), flush=True)
    if args.out and group.rank == 0 and args.task == "train":
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    sys.exit(main())
