"""A dry run of the (data, model) grid: fused R-NaD train steps of the three
net families over n ranks, the nets tensor-parallel over the model axis.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:37-101``): on n
ranks the grid is (n / 2) x 2 where n is even (one rank: 1 x 1), and one
step of each family runs at ``dryrun_multichip``'s own sizes (its tree
config, seed 0, 8 lanes a data rank): the MLP of depth 2 (the alternating
layout with its scatter before ``fc1``), the ConvNet with BatchNorm under
the noisy lift (4 channels, sigma 0.1) and the EquiNet with solver
features (2 RM+ iterations).  Each rank builds the whole net from the
seed, slices its shards (``tensor_parallel.shard_train_state``) and steps
through ``runtime.make_sharded_train_step(model_parallel=True)``; every
loss must be finite.  It runs on the card (NCCL) unless ``--cpu`` asks for
the CPU (gloo).  NCCL needs one card a rank, so ranks that share one card
take ``--backend gloo``:

    python -m rnad_tpu_torch.parallel.dryrun --cpu [--num-ranks 4]
    python -m rnad_tpu_torch.parallel.dryrun --backend gloo   # one card

``run_specs`` runs other configurations the same way (``chip_smoke.py``
phase 11: the families at full width); each rank reports a run's losses,
the checksum (sum of |w|) and SHA-256 of the gathered whole learner, the
wall time of each step, the kernels' launches, and the all-reduces of
each step on each axis with the bytes of the tensors they reduce.  Every spawned rank has a time limit
(``multiprocess_check.spawn``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import NetConfig, ObsTransformConfig, RNaDConfig, TreeConfig
from ..env import tree as tree_lib
from ..learn import rnad as rnad_lib
from ..mp_worker import checksum, param_digest
from ..models import nets
from ..ops import fused_turn, lookup, rmplus, stepping
from ..ops import obs_transform as obs_transform_lib
from ..utils import checkpoint
from . import mesh as mesh_lib
from . import runtime, tensor_parallel

# dryrun_multichip's tree and R-NaD flags (__graft_entry__.py:51-57)
TREE = TreeConfig(max_actions=3, max_transitions=2, transition_threshold=0.3,
                  depth_bound=2)
LANES_A_DATA_RANK = 8


def model_parallelism(n_ranks: int) -> int:
    """dryrun_multichip's model axis: 2 where the rank count is even."""
    return 2 if n_ranks % 2 == 0 else 1


def dryrun_specs(n_ranks: int) -> List[dict]:
    """The three families at ``dryrun_multichip``'s sizes for ``n_ranks``
    ranks: one fused step each."""
    data = n_ranks // model_parallelism(n_ranks)
    cfg = RNaDConfig(batch_size=LANES_A_DATA_RANK * data, eta=0.2,
                     bounds=(1,), delta_m=(1,), lr=1e-3, gamma_averaging=0.01,
                     logit_clip=2.0)
    lift = ObsTransformConfig(kind="lift", channels=4, sigma=0.1)
    families = [
        ("MLP", NetConfig(type="MLP", max_actions=3, width=64, depth=2), cfg),
        ("ConvNet +obs_transform",
         NetConfig(type="ConvNet", max_actions=3, channels=8, depth=1,
                   batch_norm=True),
         dataclasses.replace(cfg, obs_transform=lift)),
        ("EquiNet", NetConfig(type="EquiNet", max_actions=3, channels=8,
                              depth=2, solver_iters=2), cfg)]
    return [{"name": name, "net": net.to_json(), "rnad": rnad.to_json(),
             "tree": TREE.to_json(), "seed": 0, "steps": 1}
            for name, net, rnad in families]


def _tree(spec: dict, device: torch.device) -> tree_lib.GameTree:
    if spec.get("tree_dir"):
        root, name = os.path.split(os.path.normpath(spec["tree_dir"]))
        return checkpoint.load_tree(name, root, device=device)
    return tree_lib.generate_tree(TreeConfig.from_json(spec["tree"]),
                                  seed=spec["seed"], device=device)


def _launches() -> Dict[str, int]:
    return {"k1": fused_turn.fused_turn.launches + fused_turn.fused_turn.
            launches_bf16, "k2": lookup.lookup.launches,
            "k3": rmplus.rmplus.launches}


def run_spec(spec: dict, grid: mesh_lib.Grid) -> dict:
    """One configuration on this rank of ``grid``: ``steps`` fused steps
    from the seed's whole net, sliced into the rank's shards.  Every rank
    of the grid calls it."""
    device = grid.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tree = _tree(spec, device)
    cfg = RNaDConfig.from_json(spec["rnad"])
    net_cfg = NetConfig.from_json(spec["net"])
    seed = spec["seed"]
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(seed),
                         obs_transform_lib.out_channels(cfg.obs_transform))
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    state = tensor_parallel.shard_train_state(
        rnad_lib.init_train_state(net.to(device), generator), grid.model)
    step = runtime.make_sharded_train_step(
        tree, stepping.make_packed_tables(tree), cfg, grid,
        rnad_lib.resolve_obs_transform(net_cfg, tree, cfg),
        model_parallel=True)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    groups = {"model": grid.model.group, "data": grid.data.group}
    all_reduce = dist.all_reduce
    calls: Dict[str, int] = {}
    moved: Dict[str, int] = {}

    def counted(tensor, *args, **kwargs):
        group = kwargs.get("group", args[1] if len(args) > 1 else None)
        axis = next((k for k, g in groups.items() if g is group), "world")
        calls[axis] = calls.get(axis, 0) + 1
        moved[axis] = moved.get(axis, 0) + tensor.numel() * tensor.itemsize
        return all_reduce(tensor, *args, **kwargs)

    out = {"losses": [], "step_s": [], "collectives": [], "bytes": []}
    fused_turn.fused_turn.launches = fused_turn.fused_turn.launches_bf16 = 0
    lookup.lookup.launches = rmplus.rmplus.launches = 0
    for _ in range(spec["steps"]):
        calls.clear()
        moved.clear()
        sync()
        t0 = time.perf_counter()
        dist.all_reduce = counted
        try:
            _, metrics = step(state, spec.get("alpha", 0.5))
            sync()
        finally:
            dist.all_reduce = all_reduce
        out["step_s"].append(time.perf_counter() - t0)
        out["collectives"].append(dict(calls))
        out["bytes"].append(dict(moved))
        out["losses"].append(float(metrics["loss"]))
    out["launches"] = _launches()
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    whole = tensor_parallel.gather_module(state.net)
    out["checksum"] = checksum(whole)
    out["digest"] = param_digest(whole)
    return out


def spawn_specs(n_ranks: int, specs: Sequence[dict], *, device: str,
                backend: Optional[str] = None,
                model_parallel: Optional[int] = None,
                timeout: float = 600) -> List[dict]:
    """Runs ``specs`` on ``n_ranks`` spawned ranks on a (n / m, m) grid, m
    = ``model_parallel`` (default ``model_parallelism(n_ranks)``); returns
    each rank's result: its grid coordinates and each run's report."""
    from ..multiprocess_check import spawn

    m = model_parallel or model_parallelism(n_ranks)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as scratch:
        path = os.path.join(scratch, "specs.json")
        with open(path, "w") as f:
            json.dump(list(specs), f)
        return spawn(n_ranks, ["--specs", path, "--model-parallelism",
                               str(m)], timeout, device=device,
                     backend=backend, module="rnad_tpu_torch.parallel.dryrun")


def dryrun_multichip(n_ranks: int, *, device: str,
                     backend: Optional[str] = None,
                     timeout: float = 600) -> List[dict]:
    """One fused step of each family at ``dryrun_multichip``'s sizes on
    ``n_ranks`` spawned ranks; raises where a loss is not finite or the
    ranks' whole learners differ.  Returns each rank's result."""
    ranks = spawn_specs(n_ranks, dryrun_specs(n_ranks), device=device,
                        backend=backend, timeout=timeout)
    for spec in dryrun_specs(n_ranks):
        name = spec["name"]
        loss = ranks[0]["runs"][name]["losses"][-1]
        if not math.isfinite(loss):
            raise AssertionError(f"dryrun: non-finite loss ({name})")
        if len({r["runs"][name]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"dryrun: the ranks' learners differ "
                                 f"({name})")
        grid = (ranks[0]["data_world"], ranks[0]["model_world"])
        print(f"dryrun_multichip({n_ranks}): grid (data, model)={grid} "
              f"net={name} loss={loss:.4f} ok", flush=True)
    return ranks


def _worker(args) -> None:
    torch.set_num_threads(1)  # ranks may share the host's cores
    backend = args.backend or runtime.default_backend(args.device)
    runtime.initialize_distributed(f"localhost:{args.port}",
                                   args.num_processes, args.process_id,
                                   backend, args.device)
    try:
        grid = runtime.grid(args.model_parallelism, args.device, backend)
        with open(args.specs) as f:
            specs = json.load(f)
        runs = {spec["name"]: run_spec(spec, grid) for spec in specs}
    finally:
        runtime.shutdown()
    print(json.dumps({"rank": grid.rank, "data": grid.data.rank,
                      "model": grid.model.rank,
                      "data_world": grid.data.world,
                      "model_world": grid.model.world,
                      "device": str(grid.device), "backend": backend,
                      "runs": runs}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-ranks", type=int, default=4)
    p.add_argument("--cpu", dest="device", action="store_const",
                   const="cpu", default="cuda",
                   help="run on the CPU instead of the card")
    p.add_argument("--backend", default=None,
                   help="nccl on the card, gloo on the CPU by default")
    # a spawned rank's flags (multiprocess_check.spawn)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--specs", default=None)
    p.add_argument("--model-parallelism", type=int, default=None)
    args = p.parse_args(argv)
    if args.process_id is not None:
        _worker(args)
        return 0
    dryrun_multichip(args.num_ranks, device=args.device,
                     backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
