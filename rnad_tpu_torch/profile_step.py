"""Where a train step's time goes on the card.

    python3 -m rnad_tpu_torch.profile_step [--net mlp|equinet|flagship]

``--net mlp`` (the default) builds the demo tree (eta_sweep's config, seed
0) and the MLP path's ``RNaD`` trainer (32768 lanes, MLP width 256).
``--net equinet`` builds the EquiNet path of ``chip_smoke.py``: the A = 5
tree (65440 nodes, seed 0) and the solver-primed EquiNet (64 channels,
depth 2, 128 RM+ iterations, float32) at 32768 lanes.  ``--net flagship``
builds flagship-3's path (``docs/runs/r4-flagship3.params.json``): the
native generator's 785,768-node A = 5 depth-6 tree and the same EquiNet in
bfloat16, with flagship-3's R-NaD settings, at 32768 lanes.  It warms up, then
times one fused train step split into its phases with CUDA events
(rollout, regather and solver features, learner and frozen passes with the
loss, backward, clip + Adam + EMA), each phase's events recorded after a
sleep kernel that hides the host's enqueue time.  Then it traces a few
steps with ``torch.profiler`` and prints the device time by kernel.  Needs
a CUDA card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time

import torch

from .config import NetConfig, RNaDConfig, ShapingRule, TreeConfig
from .env import tree as tree_lib
from .learn import rnad

BATCH_SIZE = 32768
TABLE_ROWS = 20  # kernels and operators listed from the trace
FLAGSHIP_TREE = TreeConfig(max_actions=5, max_transitions=2,
                           transition_threshold=0.25, depth_bound=6,
                           depth_bound_rule=ShapingRule(-1, -2, 0.55))
CONFIGS = {
    "mlp": (TreeConfig(max_actions=3, max_transitions=2,
                       transition_threshold=0.3, depth_bound=4,
                       depth_bound_rule=ShapingRule(delta=-1,
                                                    stochastic_delta=-2,
                                                    stochastic_prob=0.5)),
            NetConfig(type="MLP", max_actions=3, width=256),
            RNaDConfig(batch_size=BATCH_SIZE, eta=0.2, lr=1e-3,
                       gamma_averaging=0.01, logit_clip=2.0)),
    "equinet": (TreeConfig(max_actions=5, max_transitions=2,
                           transition_threshold=0.25, depth_bound=5,
                           depth_bound_rule=ShapingRule(-1, -2, 0.55)),
                NetConfig(type="EquiNet", max_actions=5, channels=64,
                          depth=2, solver_iters=128, solver_prime=True),
                RNaDConfig(batch_size=BATCH_SIZE, eta=1.0, lr=5e-5,
                           gamma_averaging=0.001, logit_clip=2.0)),
    "flagship": (FLAGSHIP_TREE,
                 NetConfig(type="EquiNet", max_actions=5, channels=64,
                           depth=2, solver_iters=128, solver_prime=True,
                           compute_dtype="bfloat16"),
                 RNaDConfig(batch_size=BATCH_SIZE, eta=0.5, lr=5e-5,
                            gamma_averaging=0.001, lr_schedule="cosine",
                            lr_decay_steps=18600, lr_final_fraction=0.1,
                            policy_warmup_steps=1500)),
}


def _phases(run: rnad.RNaD, alpha: float):
    """One train step as (name, thunk) phases, in train_step's order."""
    state, cfg = run.state, run.cfg
    box = {}

    def roll():
        box["traj"] = rnad.rollout(state, run.tree, run.packed, cfg)

    def inputs():
        box["inputs"] = rnad.learner_inputs(state, run.packed, box["traj"])

    def loss():
        box["loss"], _ = rnad.learn_loss(state, run.packed, box["traj"],
                                         alpha, cfg, inputs=box["inputs"])

    def backward():
        box["grads"] = torch.autograd.grad(box["loss"],
                                           list(state.net.parameters()))

    def update():
        rnad.optimizer_update(cfg, list(state.net.parameters()),
                              list(box["grads"]), state.opt)
        rnad.ema_update(cfg.gamma_averaging, state.net, state.net_target)
        state.total_steps += 1

    return [("rollout", roll),
            ("regather (K2), EquiNet solve (K3)", inputs),
            ("learner + frozen passes, v-trace, loss", loss),
            ("backward", backward), ("clip + Adam + EMA", update)]


def phase_ms(run: rnad.RNaD, iters: int = 10):
    """Device ms of each phase, mean over ``iters`` steps."""
    names = [n for n, _ in _phases(run, 1.0)]
    total = {n: 0.0 for n in names}
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s: covers the host's enqueue
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        for _, fn in _phases(run, 1.0):
            fn()
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
        for n, a, b in zip(names, events, events[1:]):
            total[n] += a.elapsed_time(b) / iters
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", choices=sorted(CONFIGS), default="mlp")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    tree_cfg, net_cfg, cfg = CONFIGS[args.net]
    gen = (tree_lib.generate_tree_native if args.net == "flagship"
           else tree_lib.generate_tree)
    tree = gen(tree_cfg, seed=0, device="cuda")
    runs = tempfile.TemporaryDirectory(prefix="profile_step_")
    run = rnad.RNaD(tree, cfg, net_cfg, directory_name=args.net,
                    runs_root=runs.name)
    run.initialize()
    for _ in range(3):
        run.train_step(run.state, 1.0)
    torch.cuda.synchronize()

    phases = phase_ms(run)
    step = sum(phases.values())
    print(f"train step at B={BATCH_SIZE}, {net_cfg}: {step:.4f} ms device "
          f"time; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB | {card}")
    for name, ms in phases.items():
        print(f"  {name:40s} {ms:9.4f} ms  {100 * ms / step:5.1f} %")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):  # the host-bound time spreads: median of 3 runs
        start.record()
        for _ in range(10):
            run.train_step(run.state, 1.0)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 10)
    back_to_back = sorted(runs)[1]
    print(f"back-to-back steps: {back_to_back:.4f} ms per step (runs "
          + "/".join(f"{r:.4f}" for r in runs) + " ms), so the device idles "
          f"{100 * (1 - step / back_to_back):.1f} % of it waiting for the "
          "host's launches")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = 5
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run.train_step(run.state, 1.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    rows = prof.key_averages()
    # device-side rows are the kernels (and copies) themselves; the aten
    # operators that launched them carry the same time again
    kernels = sorted((e for e in rows
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in rows
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    launches = sum(e.count for e in kernels) // steps
    print(f"trace: {steps} steps, {wall:.4f} ms wall per step under the "
          f"profiler, {busy:.4f} ms device busy and {launches} kernels per "
          f"step ({100 * (1 - busy / wall):.1f} % idle)")
    for title, table in (("kernels", kernels), ("operators", ops)):
        print(f"  {title} by device time per step:")
        for e in table[:TABLE_ROWS]:
            print(f"  {e.self_device_time_total / steps / 1e3:9.4f} ms "
                  f"{e.count // steps:5d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
