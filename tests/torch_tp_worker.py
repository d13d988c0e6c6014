"""One rank of the model-axis test cases of tests/test_torch_model_parallel.py.

Run by ``rnad_tpu_torch.multiprocess_check.spawn`` as ``python -m
tests.torch_tp_worker ... --model-parallelism M``; it imports the port
only (no JAX).  The rank joins the world, takes its place on the (world /
M, M) grid (``runtime.grid``) and runs every case of ``--cases`` (a
``torch.save``d dict of named cases), each of one kind:

* ``learn``: one learner update on this rank's lanes (of its data
  coordinate) of a fixed global trajectory, from given whole weights
  sliced into this rank's shards (``shard_train_state``); a solver
  EquiNet's case may give the RM+ solves of the trajectory's games
  (``rnad_tpu``'s), which then stand in for the port's;
* ``train``: ``steps`` fused steps (``make_sharded_train_step(
  model_parallel=True)``: the gathered actor's rollout, then the update)
  from the seed's weights;
* ``op``: one of the four operators inside a small function of whole
  inputs; the gradients of the function with respect to them;
* ``save``: a fresh ``RNaD`` run under the grid in ``run_dir``, ``steps``
  fused steps, then checkpoint (0, steps);
* ``resume``: an ``RNaD`` run under the grid resumed from ``run_dir``;
* ``buffered``: a fresh ``RNaD`` run under the grid, ``steps`` buffered
  steps (``RNaD.buffered_step``) from an empty buffer; their losses.

Each rank saves ``rank<i>.pt`` under ``--out``: per case the global
metrics, the gathered whole state (``gather_train_state``: the four nets'
state dicts and Adam's moments), this rank's shards of the learner, and
the gradients of an ``op`` case.
"""

import argparse
import json
import os

import torch

from rnad_tpu_torch import config
from rnad_tpu_torch.env import engine
from rnad_tpu_torch.learn import buffer as buffer_lib
from rnad_tpu_torch.learn import rnad
from rnad_tpu_torch.models import nets
from rnad_tpu_torch.ops import obs_transform as obs_transform_lib
from rnad_tpu_torch.ops import stepping
from rnad_tpu_torch.parallel import runtime, tensor_parallel
from rnad_tpu_torch.parallel.shard_map_step import lane_slice
from rnad_tpu_torch.utils import checkpoint

OPS = ("copy", "reduce", "gather", "scatter")


def op_function(name, x, w, g, model):
    """The small function of an ``op`` case, on this rank's view of the
    whole inputs x (N, D), w (H, D) and g: the operator ``name`` at its
    centre, the loss whole on every rank.  ``model`` None: one rank's
    plain function.  Returns (loss, the tensors to differentiate)."""
    tp = tensor_parallel
    if model is None:  # every variant is this function of whole tensors
        return (torch.tanh(x @ w.t()) * g).sum(), [x, w]
    part = lambda t, dim: t.narrow(dim, *model.part(t.shape[dim]))
    if name == "copy":  # column-parallel: this rank's output rows of w
        w_r = part(w, 0).clone().requires_grad_(True)
        y = torch.tanh(tp.copy_to_model(x, model) @ w_r.t()) * part(g, 1)
        return tp.reduce_from_model(y.sum(), model), [x, w_r]
    if name == "reduce":  # row-parallel: this rank's input columns
        x_r = part(x, 1).clone().requires_grad_(True)
        w_r = part(w, 1).clone().requires_grad_(True)
        y = tp.reduce_from_model(x_r @ w_r.t(), model)
        return (torch.tanh(y) * g).sum(), [x_r, w_r]
    if name == "gather":  # this rank's output columns, gathered
        w_r = part(w, 0).clone().requires_grad_(True)
        y = tp.gather_from_model(tp.copy_to_model(x, model) @ w_r.t(), 1,
                                 w.shape[0], model)
        return (torch.tanh(y) * g).sum(), [x, w_r]
    # scatter: the whole x, this rank's columns feeding a row-parallel sum
    w_r = part(w, 1).clone().requires_grad_(True)
    y = tp.reduce_from_model(tp.scatter_to_model(x, 1, model) @ w_r.t(),
                             model)
    return (torch.tanh(y) * g).sum(), [x, w_r]


def _op(case, grid):
    x = case["x"].clone().requires_grad_(True)
    loss, wrt = op_function(case["name"], x, case["w"], case["g"],
                            grid.model)
    return {"loss": float(loss),
            "grads": torch.autograd.grad(loss, wrt)}


def _whole(state):
    whole = tensor_parallel.gather_train_state(state)
    return {"nets": {n: getattr(whole, n).state_dict()
                     for n in tensor_parallel.NETS},
            "mu": whole.opt.mu, "nu": whole.opt.nu}


def _run(case, grid, tree):
    cfg = config.RNaDConfig.from_json(case["cfg"])
    net_cfg = config.NetConfig.from_json(case["net"])
    trainer = rnad.RNaD(tree, cfg, net_cfg, directory_name="run",
                        runs_root=case["run_dir"], seed=case["seed"],
                        device="cpu", group=grid)
    trainer.initialize()
    if case["kind"] == "buffered":
        buffer = buffer_lib.TrajectoryBuffer(cfg.n_batches_per_buffer)
        losses = [float(trainer.buffered_step(buffer, 0.5)["loss"])
                  for _ in range(case["steps"])]
        return trainer.state, {"losses": losses}
    for _ in range(case.get("steps", 0)):
        trainer.train_step(trainer.state, 0.5)
    if case["kind"] == "save":
        trainer.m, trainer.n = 0, trainer.state.total_steps
        trainer.save_checkpoint()
        grid.barrier()  # the checkpoint is written before any rank exits
    return trainer.state, {}


def _case(case, grid):
    if case["kind"] == "op":
        return _op(case, grid)
    root, name = os.path.split(case["tree_dir"])
    tree = checkpoint.load_tree(name, root, device="cpu")
    if case["kind"] in ("save", "resume", "buffered"):
        state, out = _run(case, grid, tree)
        return {"whole": _whole(state), "total_steps": state.total_steps,
                "shards": state.net.state_dict(), **out}
    cfg = config.RNaDConfig.from_json(case["cfg"])
    net_cfg = config.NetConfig.from_json(case["net"])
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(case["seed"]),
                         obs_transform_lib.out_channels(cfg.obs_transform))
    if "state_dict" in case:
        net.load_state_dict(case["state_dict"])
    state = tensor_parallel.shard_train_state(rnad.init_train_state(
        net, torch.Generator().manual_seed(case["seed"] + 1)), grid.model)
    packed = stepping.make_packed_tables(tree)
    if case["kind"] == "learn":
        lanes = grid.data.lanes(cfg.batch_size)
        traj = engine.Trajectory(**case["traj"])
        solve = nets.solver_device.solve_zero_sum_rmplus
        if "solves" in case:  # given solves of the games, (t, lane) order
            T = traj.rewards.shape[0]
            mine = [t.reshape(T, cfg.batch_size, *t.shape[1:])[:, lanes]
                    .reshape(-1, *t.shape[1:]) for t in case["solves"]]
            nets.solver_device.solve_zero_sum_rmplus = lambda *a, **k: mine
        try:
            metrics = rnad.learn_step(state, packed, lane_slice(traj, lanes),
                                      case["alpha"], cfg, grid.data)
        finally:
            nets.solver_device.solve_zero_sum_rmplus = solve
    else:
        step = runtime.make_sharded_train_step(
            tree, packed, cfg, grid,
            rnad.resolve_obs_transform(net_cfg, tree, cfg),
            model_parallel=True)
        for _ in range(case["steps"]):
            _, metrics = step(state, case["alpha"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "whole": _whole(state), "shards": state.net.state_dict()}


def main():
    p = argparse.ArgumentParser()
    for flag in ("--process-id", "--num-processes", "--port",
                 "--model-parallelism"):
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
        grid = runtime.grid(args.model_parallelism, args.device, backend)
        cases = torch.load(args.cases, weights_only=True)
        results = {name: _case(case, grid) for name, case in cases.items()}
    finally:
        runtime.shutdown()
    torch.save(results, os.path.join(args.out, f"rank{grid.rank}.pt"))
    print(json.dumps({"rank": grid.rank, "data": grid.data.rank,
                      "model": grid.model.rank}))


if __name__ == "__main__":
    main()
