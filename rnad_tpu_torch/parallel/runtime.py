"""Process-group set-up and the sharded train step.

Counterpart of ``rnad_tpu/parallel/runtime.py``.  Every process is one rank
of the world: it joins the others through ``torch.distributed`` (NCCL on
the card, gloo on the CPU; the backend is chosen by the device and never
switched) and works on ``cuda:(rank % device_count)`` or the CPU.  Its
handle is the data axis (``data_group``: the world is one data axis, the
weights replicated) or a (data, model) grid (``grid``,
``mesh.make_grid``): it trains on its data coordinate's slice of the lanes
and, under ``model_parallel``, holds its model coordinate's shards of the
weights (``tensor_parallel.py``).

Determinism across rank counts: every rank draws the *global* turn noise
from the replicated ``state.generator``, with the shapes and order of one
device (``env/engine.py::turn_noise``), and keeps its own lanes; so a run
samples the same episodes (equal indices, actions and rewards) whatever
the rank count, as ``rnad_tpu``'s partitionable threefry does.  The learner
update is the unsharded one up to summation order (``learn.rnad.
learn_step``).  The stored behaviour policy is a softmax per lane and
matches to float tolerance where the rank count changes the kernel's or
the plain version's blocking.

Every configuration of the one-device trainer runs here:

* A ConvNet's BatchNorm normalizes over the global batch, as GSPMD does
  over ``rnad_tpu``'s sharded lane axis: two differentiable all-reduces
  (``DataGroup.global_sum_grad``) a BatchNorm in the forward and two in the
  backward (``models/nets.py::MaskedBatchNorm``), and no averaging of the
  running statistics afterwards (``learn_step``'s "global").  The
  per-rank-stream step of ``shard_map_step.py`` keeps ``rnad_tpu``'s
  non-sync per-rank BatchNorm.
* The buffered step keeps this rank's lanes of each rollout in its buffer;
  every rank draws the same global sampling plan, and the lanes its
  collated positions need from other ranks arrive in one all-reduce per
  dtype (``learn/buffer.py::TrajectoryBuffer.sample``), the exchange
  ``rnad_tpu``'s GSPMD inserts for ``learn_jit.sampled``.

Under ``model_parallel`` (``rnad_tpu``'s ``model_parallel_mlp``) the
rollout's route is: once a step every rank gathers the learner's whole
weights, without gradient, into a whole actor net (``tensor_parallel.
gather_module``, one all-reduce over its model row) and rolls out with it
on the one-device path: kernel K1 for the depth-1 float32 MLP (K1 reads
whole weights, ``ops/fused_turn.py::fits``), the generic turn otherwise
(K2, and K3 for a solver EquiNet).  Every model rank of a data row cuts
the same lanes and noise by its data coordinate, so their trajectories
are bitwise equal; the learner then runs on the shards.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import socket
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ..config import RNaDConfig
from ..env import engine
from ..env.engine import local_noise
from ..env.tree import GameTree
from ..learn import rnad as rnad_lib
from ..ops import stepping
from ..ops.obs_transform import ObsTransform
from ..utils import timing
from . import mesh as mesh_lib
from . import tensor_parallel

host_value = mesh_lib.host_value

# how long a collective, or the group's forming, may wait for a rank
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank i's device: ``cuda:(i % device_count)``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu (device_type='cpu') "
                           "to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device_type: str = "cuda") -> None:
    """Joins this process to an ``num_processes``-rank group through the
    coordinator ``host:port`` (rank ``process_id``; rank 0 serves the
    store).  A no-op for a single process.  ``backend`` defaults to
    ``default_backend(device_type)``; a caller passes another one
    explicitly, such as gloo for ranks that share one card (NCCL refuses
    them)."""
    if num_processes is None or num_processes <= 1:
        logging.info("single-process run")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator host:port "
                         "and --process-id")
    _init(f"tcp://{coordinator_address}", num_processes, process_id,
          backend or default_backend(device_type), device_type)
    logging.info("distributed: process %d/%d over %s", process_id,
                 num_processes, dist.get_backend())


def _init(init_method: str, world: int, rank: int, backend: str,
          device_type: str) -> None:
    kw = {}
    if device_type == "cuda":
        device = rank_device(rank, device_type)
        torch.cuda.set_device(device)
        if backend == "nccl":  # binds the communicator to the rank's card
            kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT, **kw)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(device_type: str, backend: Optional[str]) -> None:
    """Without a process group yet, forms a world of the ranks this process
    spans: one rank on one device, over a store on a free localhost
    port."""
    if not dist.is_initialized():
        _init(f"tcp://localhost:{free_port()}", 1, 0,
              backend or default_backend(device_type), device_type)


def data_group(device_type: str = "cuda", backend: Optional[str] = None
               ) -> mesh_lib.DataGroup:
    """This process's rank of the world as one data axis."""
    _join(device_type, backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    return mesh_lib.DataGroup(rank=rank, world=world,
                              device=rank_device(rank, device_type))


def grid(model_parallelism: int = 1, device_type: str = "cuda",
         backend: Optional[str] = None) -> mesh_lib.Grid:
    """This process's place on the (world / m, m) grid of the world, m =
    ``model_parallelism`` (``mesh.make_grid``; every rank calls it)."""
    _join(device_type, backend)
    return mesh_lib.make_grid(model_parallelism,
                              rank_device(dist.get_rank(), device_type))


def shutdown() -> None:
    """Leaves the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def check_data_parallel(cfg: RNaDConfig, group: mesh_lib.DataGroup) -> None:
    """Raises ValueError before anything runs where the batch does not
    divide over the ranks."""
    group.lanes(cfg.batch_size)


def _data_axis(group: Union[mesh_lib.DataGroup, mesh_lib.Grid],
          model_parallel: bool) -> mesh_lib.DataGroup:
    """The data axis of ``group``; raises where ``model_parallel`` asks
    for a model axis that ``group`` lacks."""
    if isinstance(group, mesh_lib.Grid):
        return group.data
    if model_parallel:
        raise ValueError("model_parallel needs a (data, model) grid "
                         "(runtime.grid), not a data group")
    return group


def make_sharded_rollout(tree: GameTree, packed: stepping.PackedTables,
                         cfg: RNaDConfig,
                         group: Union[mesh_lib.DataGroup, mesh_lib.Grid],
                         obs_transform: Optional[ObsTransform] = None,
                         model_parallel: bool = False):
    """``rollout(state, noise=None)``: this rank's lanes (of its data
    coordinate) of the global ``cfg.batch_size``-lane rollout.  ``noise``
    is the global per-turn noise; None draws it from ``state.generator``
    (which every rank advances alike).  Under ``model_parallel`` the
    state's nets are tensor-parallel and the rollout reads the learner's
    whole weights, gathered into an actor net (module docstring)."""
    data = _data_axis(group, model_parallel)
    lanes = data.lanes(cfg.batch_size)
    local_cfg = dataclasses.replace(cfg, batch_size=lanes.stop - lanes.start)
    A, T = packed.max_actions, packed.max_transitions
    channels = None if obs_transform is None else obs_transform.channels
    actor = []  # the whole actor net under model_parallel, made once

    def rollout(state: rnad_lib.TrainState, noise=None) -> engine.Trajectory:
        if model_parallel:
            actor[:] = [tensor_parallel.gather_module(state.net, *actor)]
            state = dataclasses.replace(state, net=actor[0])
        if noise is None:
            noise = [engine.turn_noise(cfg.batch_size, A, T, state.generator,
                                       packed.rows.device, channels)
                     for _ in range(tree.max_depth)]
        noise: List = [local_noise(n, lanes, cfg.batch_size) for n in noise]
        return rnad_lib.rollout(state, tree, packed, local_cfg, noise,
                                obs_transform)

    return rollout


def make_sharded_train_step(tree: GameTree, packed: stepping.PackedTables,
                            cfg: RNaDConfig,
                            group: Union[mesh_lib.DataGroup, mesh_lib.Grid],
                            obs_transform: Optional[ObsTransform] = None,
                            model_parallel: bool = False):
    """The fused step of one rank, ``train_step(state, alpha, noise=None)``
    (the signature of ``learn.rnad.make_train_step``'s): its lanes of the
    global-stream rollout (kernel K1, or the generic turn), one regather
    (K2) and the group-aware ``learn_step`` over the data axis (a
    ConvNet's BatchNorm over the global batch); returns (state, metrics),
    the metrics global.  ``group`` is the data axis or a grid; under
    ``model_parallel`` (``rnad_tpu``'s ``make_sharded_rnad_fns(
    model_parallel_mlp=True)``) the state is tensor-parallel over the
    grid's model axis (``tensor_parallel.shard_train_state``), otherwise
    its weights are replicated on every rank.  Raises where
    ``check_data_parallel`` does, and under ``model_parallel`` without a
    grid."""
    data = _data_axis(group, model_parallel)
    check_data_parallel(cfg, data)
    rollout = make_sharded_rollout(tree, packed, cfg, group, obs_transform,
                                   model_parallel)

    def train_step(state: rnad_lib.TrainState, alpha: float, noise=None):
        with timing.span("rnad.train_step"):
            traj = rollout(state, noise)
            return state, rnad_lib.learn_step(state, packed, traj, alpha,
                                              cfg, data, batch_norm="global")

    return train_step
