"""One rank of the data-parallel test cases of tests/test_torch_parallel.py.

Run by ``rnad_tpu_torch.multiprocess_check.spawn`` as ``python -m
tests.torch_dist_worker``; it imports the port only (no JAX).  ``--cases``
is a ``torch.save``d dict of named cases, each of one kind:

* ``learn``: the port's ``make_shard_map_learn_step`` on a fixed global
  trajectory from given weights;
* ``train``: ``steps`` steps of ``make_shard_map_train_step`` (one rollout
  stream a rank) from the seed's weights.

Each rank saves ``rank<i>.pt`` under ``--out``: per case the global
metrics, the learner's state dict (weights and BatchNorm buffers) and the
losses of a ``train`` case.
"""

import argparse
import json
import os

import torch

from rnad_tpu_torch import config
from rnad_tpu_torch.env import engine
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.parallel import runtime, shard_map_step
from rnad_tpu_torch.utils import checkpoint


def _case(case, group):
    root, name = os.path.split(case["tree_dir"])
    tree = checkpoint.load_tree(name, root, device="cpu")
    cfg = config.RNaDConfig.from_json(case["cfg"])
    net = nets.build_net(config.NetConfig.from_json(case["net"]),
                         torch.Generator().manual_seed(case.get("seed", 0)))
    if "state_dict" in case:
        net.load_state_dict(case["state_dict"])
    state = rnad.init_train_state(
        net, torch.Generator().manual_seed(case.get("seed", 0) + 1))
    if case["kind"] == "learn":
        learn = shard_map_step.make_shard_map_learn_step(tree, cfg, group)
        metrics = learn(state, engine.Trajectory(**case["traj"]),
                        case["alpha"])
        out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    else:
        step = shard_map_step.make_shard_map_train_step(tree, cfg, group)
        out = {"losses": [float(step(state, 0.5)[1]["loss"])
                          for _ in range(case["steps"])],
               "total_steps": state.total_steps}
    out["state_dict"] = {k: v.clone() for k, v in net.state_dict().items()}
    return out


def main():
    p = argparse.ArgumentParser()
    for flag in ("--process-id", "--num-processes", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cpu")
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    runtime.initialize_distributed(f"localhost:{args.port}",
                                   args.num_processes, args.process_id,
                                   args.backend, args.device)
    try:
        group = runtime.data_group(args.device, args.backend)
        cases = torch.load(args.cases, weights_only=True)
        results = {name: _case(case, group) for name, case in cases.items()}
    finally:
        runtime.shutdown()
    torch.save(results, os.path.join(args.out, f"rank{group.rank}.pt"))
    print(json.dumps({"rank": group.rank, "world": group.world}))


if __name__ == "__main__":
    main()
