"""One rank of the data-parallel test cases of tests/test_torch_parallel.py
and tests/test_torch_parallel_global.py.

Run by ``rnad_tpu_torch.multiprocess_check.spawn`` as ``python -m
tests.torch_dist_worker``; it imports the port only (no JAX).  ``--cases``
is a ``torch.save``d dict of named cases, each of one kind:

* ``learn``: one learner update on this rank's lanes of a fixed global
  trajectory from given weights, with the BatchNorm semantic the case
  names: "per_rank" (default; ``make_shard_map_learn_step``) or "global"
  (``learn_step`` as the global-stream path runs it);
* ``train``: ``steps`` steps of ``make_shard_map_train_step`` (one rollout
  stream a rank) from the seed's weights;
* ``bn_grad``: a train-mode ``MaskedBatchNorm`` over the global batch on
  this rank's samples of ``x``; the gradients of sum(y * g) with respect
  to its samples and (summed over the ranks) to the scale;
* ``sample``: ``TrajectoryBuffer.sample`` under the group, the buffer
  holding this rank's lanes of each global slot, ``draws`` times from one
  seeded generator;
* ``buffered_learn``: one such sample, then ``learn_step`` on it.

Each rank saves ``rank<i>.pt`` under ``--out``: per case the global
metrics, the learner's state dict (weights and BatchNorm buffers), the
losses of a ``train`` case, the gradients of a ``bn_grad`` case and the
sampled fields of a ``sample`` case.
"""

import argparse
import json
import os

import numpy as np
import torch

from rnad_tpu_torch import config
from rnad_tpu_torch.env import engine
from rnad_tpu_torch.learn import buffer as buffer_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import stepping
from rnad_tpu_torch.parallel import runtime, shard_map_step
from rnad_tpu_torch.utils import checkpoint


def _bn_grad(case, group):
    x, mask, g = case["x"], case["mask"], case["g"]
    lanes = group.lanes(x.shape[0])
    bn = nets.MaskedBatchNorm(x.shape[1])
    bn.load_state_dict(case["bn"])
    xr = x[lanes].clone().requires_grad_(True)
    y = bn(xr, train=True, mask=mask[lanes], group=group)
    grad_x, grad_scale = torch.autograd.grad((y * g[lanes]).sum(),
                                             [xr, bn.scale])
    return {"grad_x": grad_x, "grad_scale": group.global_sum(grad_scale),
            "y": y.detach(), "state_dict": bn.state_dict()}


def _local_buffer(case, group):
    buf = buffer_lib.TrajectoryBuffer(len(case["slots"]))
    for slot in case["slots"]:
        lanes = group.lanes(slot["indices"].shape[1])
        buf.append(engine.Trajectory(**{
            k: v[:, lanes].contiguous() if torch.is_tensor(v) else v
            for k, v in slot.items()}))
    return buf, np.random.default_rng(case["rng_seed"])


def _sample(case, group):
    buf, rng = _local_buffer(case, group)
    draws = []
    for _ in range(case["draws"]):
        traj = buf.sample(case["batch_size"], rng, group)
        draws.append({k: v for k, v in vars(traj).items()
                      if torch.is_tensor(v)})
    return {"draws": draws}


def _case(case, group):
    if case["kind"] == "bn_grad":
        return _bn_grad(case, group)
    if case["kind"] == "sample":
        return _sample(case, group)
    root, name = os.path.split(case["tree_dir"])
    tree = checkpoint.load_tree(name, root, device="cpu")
    cfg = config.RNaDConfig.from_json(case["cfg"])
    net = nets.build_net(config.NetConfig.from_json(case["net"]),
                         torch.Generator().manual_seed(case.get("seed", 0)))
    if "state_dict" in case:
        net.load_state_dict(case["state_dict"])
    state = rnad.init_train_state(
        net, torch.Generator().manual_seed(case.get("seed", 0) + 1))
    if case["kind"] == "learn" and case.get("batch_norm") == "global":
        traj = shard_map_step.lane_slice(engine.Trajectory(**case["traj"]),
                                         group.lanes(cfg.batch_size))
        metrics = rnad.learn_step(state, stepping.make_packed_tables(tree),
                                  traj, case["alpha"], cfg, group,
                                  batch_norm="global")
        out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    elif case["kind"] == "learn":
        learn = shard_map_step.make_shard_map_learn_step(tree, cfg, group)
        metrics = learn(state, engine.Trajectory(**case["traj"]),
                        case["alpha"])
        out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    elif case["kind"] == "buffered_learn":
        buf, rng = _local_buffer(case, group)
        traj = buf.sample(cfg.batch_size, rng, group)
        metrics = rnad.learn_step(state, stepping.make_packed_tables(tree),
                                  traj, case["alpha"], cfg, group)
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
    p.add_argument("--backend", default=None)
    p.add_argument("--cpu", dest="device", action="store_const",
                   const="cpu", default="cuda")
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    backend = args.backend or runtime.default_backend(args.device)
    runtime.initialize_distributed(f"localhost:{args.port}",
                                   args.num_processes, args.process_id,
                                   backend, args.device)
    try:
        group = runtime.data_group(args.device, backend)
        cases = torch.load(args.cases, weights_only=True)
        results = {name: _case(case, group) for name, case in cases.items()}
    finally:
        runtime.shutdown()
    torch.save(results, os.path.join(args.out, f"rank{group.rank}.pt"))
    print(json.dumps({"rank": group.rank, "world": group.world}))


if __name__ == "__main__":
    main()
