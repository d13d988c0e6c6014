"""The port's headline benchmark: the counterpart of ``bench.py``.

    python3 -m rnad_tpu_torch.bench [--cpu]

Prints one JSON line:

    {"metric": "env_half_steps_per_s_per_chip", "value": N,
     "unit": "steps/s", "rollout_batch": B, "rollout_rates": {"B": N, ...},
     "train_updates_per_s": N, "train_env_steps_per_s": N,
     "device": "<card>", "power_limit_w": W}

The headline is bench.py's: environment half-steps per second (one per
player per tree level) of the whole actor phase, that is the rollout with
the actor net's inference and the action sampling.  It runs on the
reference demo tree (A = 3, depth bound 4 with the stochastic rule, seed 0)
with the width-256 MLP, each turn one launch of kernel K1
(``env/engine.py::rollout_from`` under ``rows_actor="auto"``), the behavior
policy recorded as (T, A, B) (``policy_minor``, as bench.py rolls out), the
Gumbel noise drawn on the device from a ``torch.Generator``.  ``(1 << 26)
// B`` rollouts run back to back at B = 32768 and at 131072 lanes; the better
rate is the headline and both are in ``rollout_rates``.  bench.py's two
self-checks ride in the timed loop on the device and are read once, at its
end, where the host clock stops: the lowest per-lane std of the episode
signature (the terminal reward times the half-step of termination; lanes
whose noise collapsed would all play one episode) must be positive, and
the mean return must lie in [-1, 1].

The ``train_*`` keys time the product, bench.py's configuration: the fused
R-NaD step (rollout, learner and frozen passes, v-trace, losses, clip +
Adam, EMA) at 32768 lanes, the MLP and its frozen passes in bfloat16.  A
bfloat16 MLP rolls out through the generic turn (one K2 launch a turn: K1
computes in float32), which stores the observations the learner reads
(``store_rollout_obs``).  After three warm steps at alpha 0.5, 256 steps
run back to back under a host clock that ends in the fetch of their
losses, which must all be finite.

Runs on the card unless ``--cpu`` is given, and without a card exits
nonzero before printing anything.  ``device`` is
``torch.cuda.get_device_name(0)`` ("cpu" under ``--cpu``, whose numbers are
no device's) and ``power_limit_w`` the card's power limit as nvidia-smi
reports it.  bench.py's ``vs_baseline`` is left out: it divides by
BASELINE.md's target, which was set for a TPU v5p.  TF32 is off for
matmuls and cuDNN, and cuDNN runs its deterministic algorithms, as in
``RNaD``.

Not ported, as a TPU-only workaround that changes no value: the
one-program scan of all rollouts (torch has none, so every rollout and
step is launched from the host, and the host's enqueue is part of the
rate).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from .config import NetConfig, RNaDConfig, ShapingRule, TreeConfig
from .env import engine
from .env import tree as tree_lib
from .learn import rnad
from .models import nets
from .ops import stepping

# the reference demo tree (main.py:31-39) and the actor of the rollout
TREE_CONFIG = TreeConfig(max_actions=3, max_transitions=2,
                         transition_threshold=0.3, depth_bound=4,
                         depth_bound_rule=ShapingRule(
                             delta=-1, stochastic_delta=-2,
                             stochastic_prob=0.5))
NET_CONFIG = NetConfig(type="MLP", max_actions=3, width=256)
ROLLOUT_BATCHES = (1 << 15, 1 << 17)
# the product: bench.py's train step at 32768 lanes
TRAIN_CONFIG = RNaDConfig(batch_size=1 << 15, eta=0.2, bounds=(10**9,),
                          delta_m=(10**9,), lr=5e-4, gamma_averaging=0.001,
                          logit_clip=2.0, fuse_net_passes="auto",
                          frozen_net_dtype="bfloat16")
TRAIN_NET_CONFIG = NetConfig(type="MLP", max_actions=3, width=256,
                             compute_dtype="bfloat16")
TRAIN_STEPS = 256
WARM_ROLLOUTS = 3
WARM_STEPS = 3
ALPHA = 0.5


def rollout_iters(batch: int) -> int:
    """Rollouts timed at ``batch`` lanes (bench.py's rule)."""
    return (1 << 26) // batch


def setup(cpu: bool, program: str) -> torch.device:
    """The device of a run: the card, or the CPU under ``--cpu``.  Without
    a card and without ``--cpu`` it exits nonzero.  Sets TF32 off and
    cuDNN deterministic, as ``RNaD`` does."""
    if not cpu and not torch.cuda.is_available():
        raise SystemExit(f"{program} runs on a CUDA card; pass --cpu to run "
                         "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cpu" if cpu else "cuda")


def card(device: torch.device) -> dict:
    """The ``device`` and ``power_limit_w`` of every output line: the
    card's name and its power limit in watts (nvidia-smi), or "cpu" and
    None."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return {"device": torch.cuda.get_device_name(0),
            "power_limit_w": float(out.stdout.splitlines()[0])}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def signature_weights(num_half_steps: int, device) -> torch.Tensor:
    """bench.py's ``t_weights``: (T, 1) weights 1 .. T.  A lane's rewards
    are nonzero only at the half-step that ends its episode, so the
    weighted sum is its terminal reward times the time of termination."""
    return torch.arange(1.0, num_half_steps + 1.0, device=device)[:, None]


def measured(traj: engine.Trajectory, weights: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a timed rollout keeps on the device (bench.py's expressions):
    the sum of its rewards, and the std over the lanes (population, as
    ``jnp.std``) of the episode signature."""
    signature = (traj.rewards * weights).sum(0)
    return traj.rewards.sum(), signature.std(correction=0)


def time_rollouts(rollout: Callable[[], engine.Trajectory], n: int
                  ) -> Tuple[float, engine.Trajectory]:
    """Seconds a rollout over ``n`` calls of ``rollout`` back to back,
    after ``WARM_ROLLOUTS`` calls (the first builds the kernels), and the
    last trajectory.  The self-checks accumulate on the device and are
    read once, where the clock stops; raises if one fails."""
    for _ in range(WARM_ROLLOUTS):
        traj = rollout()
    device = traj.rewards.device
    weights = signature_weights(traj.num_half_steps, device)
    acc = torch.zeros((), device=device)
    min_std = torch.full((), 1e9, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        traj = rollout()
        total, std = measured(traj, weights)
        acc += total
        min_std = torch.minimum(min_std, std)
    min_std = float(min_std)
    dt = time.perf_counter() - t0
    if not min_std > 0.0:
        raise AssertionError("lane collapse in the measured rollouts: an "
                             "episode signature's std is 0")
    # terminal values lie in [-1, 1]
    mean_return = float(acc) / (traj.batch_size * n)
    if not abs(mean_return) <= 1.0:
        raise AssertionError(f"rollouts computed garbage: mean return "
                             f"{mean_return}")
    return dt / n, traj


def time_steps(step: Callable[[], torch.Tensor], n: int, device
               ) -> Tuple[float, torch.Tensor]:
    """Seconds a step over ``n`` calls of ``step`` (which returns the
    step's loss) back to back, after ``WARM_STEPS`` calls and a
    synchronize, the clock ending in the fetch of the losses; and the
    losses, which must be finite."""
    for _ in range(WARM_STEPS):
        step()
    synchronize(device)
    t0 = time.perf_counter()
    losses = torch.stack([step() for _ in range(n)]).cpu()
    dt = time.perf_counter() - t0
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss: {losses.tolist()}")
    return dt / n, losses


def actor_net(device) -> torch.nn.Module:
    """The rollout's width-256 MLP, drawn from seed 0 on the CPU."""
    return nets.build_net(NET_CONFIG,
                          torch.Generator().manual_seed(0)).to(device)


def rollout_fn(tree: tree_lib.GameTree, packed: stepping.PackedTables,
               net: torch.nn.Module, batch: int,
               generator: torch.Generator, rows_actor: str = "auto",
               actor_dtype: torch.dtype = torch.float32,
               lane_chunks: int = 1, policy_minor: bool = False
               ) -> Callable[[], engine.Trajectory]:
    """One rollout of ``batch`` lanes from the root, its noise drawn from
    ``generator``, in ``lane_chunks`` sub-batches, the behavior policy
    recorded (T, A, B) under ``policy_minor``."""
    init = torch.ones((batch,), dtype=torch.int32, device=tree.device)
    return lambda: engine.rollout_from(
        tree, packed, net, init, tree.max_depth, generator=generator,
        rows_actor=rows_actor, actor_dtype=actor_dtype,
        lane_chunks=lane_chunks, policy_minor=policy_minor)


def train_setup(tree: tree_lib.GameTree, packed: stepping.PackedTables):
    """The product's state (nets drawn from seed 2) and fused train step
    (``make_train_step``) on ``tree``'s device."""
    rnad.check_supported(TRAIN_CONFIG, TRAIN_NET_CONFIG)
    net = nets.build_net(TRAIN_NET_CONFIG, torch.Generator().manual_seed(2))
    generator = torch.Generator(device=tree.device).manual_seed(3)
    state = rnad.init_train_state(net.to(tree.device), generator)
    return state, rnad.make_train_step(tree, packed, TRAIN_CONFIG)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parses ``argv`` (default: the command line), prints the JSON line
    and returns it."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    device = setup(args.cpu, "bench")
    tree = tree_lib.generate_tree(TREE_CONFIG, seed=0, device=device)
    packed = stepping.make_packed_tables(tree)
    net = actor_net(device)
    generator = torch.Generator(device=device).manual_seed(1)
    half_steps = 2 * tree.max_depth
    rates = {}
    for batch in ROLLOUT_BATCHES:
        dt, _ = time_rollouts(rollout_fn(tree, packed, net, batch,
                                         generator, policy_minor=True),
                              rollout_iters(batch))
        rates[batch] = half_steps * batch / dt
    best = max(rates, key=rates.get)

    state, train_step = train_setup(tree, packed)
    step_s, _ = time_steps(
        lambda: train_step(state, ALPHA)[1]["loss"], TRAIN_STEPS, device)
    updates_per_s = 1.0 / step_s
    line = {
        "metric": "env_half_steps_per_s_per_chip",
        "value": round(rates[best], 1),
        "unit": "steps/s",
        "rollout_batch": best,
        "rollout_rates": {str(b): round(r, 1) for b, r in rates.items()},
        "train_updates_per_s": round(updates_per_s, 1),
        "train_env_steps_per_s": round(
            updates_per_s * TRAIN_CONFIG.batch_size * half_steps, 1),
        **card(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
