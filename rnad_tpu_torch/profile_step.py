"""Where a train step's time goes on the card.

    python3 -m rnad_tpu_torch.profile_step

Builds the demo tree (eta_sweep's config, seed 0) and the main path's
``RNaD`` trainer (32768 lanes, MLP width 256), warms up, then times one fused train
step split into its phases with CUDA events (rollout, regather and
learner loss, backward, clip + Adam + EMA), each phase's events recorded
after a sleep kernel that hides the host's enqueue time.  Then it traces
a few steps with ``torch.profiler`` and prints the device time by kernel.
Needs a CUDA card; prints the card's name and power limit beside the
numbers.
"""

from __future__ import annotations

import subprocess
import time

import torch

from .config import NetConfig, RNaDConfig, ShapingRule, TreeConfig
from .env import tree as tree_lib
from .learn import rnad

BATCH_SIZE = 32768
WIDTH = 256
TABLE_ROWS = 20  # kernels and operators listed from the trace
DEMO_TREE = TreeConfig(max_actions=3, max_transitions=2,
                       transition_threshold=0.3, depth_bound=4,
                       depth_bound_rule=ShapingRule(delta=-1,
                                                    stochastic_delta=-2,
                                                    stochastic_prob=0.5))


def _phases(run: rnad.RNaD, alpha: float):
    """One train step as (name, thunk) phases, in train_step's order."""
    state, cfg = run.state, run.cfg
    box = {}

    def roll():
        box["traj"] = rnad.rollout(state, run.tree, run.packed, cfg)

    def loss():
        box["loss"], _ = rnad.learn_loss(state, run.packed, box["traj"],
                                         alpha, cfg)

    def backward():
        box["grads"] = torch.autograd.grad(box["loss"],
                                           list(state.net.parameters()))

    def update():
        rnad.optimizer_update(cfg, list(state.net.parameters()),
                              list(box["grads"]), state.opt)
        rnad.ema_update(cfg.gamma_averaging, state.net, state.net_target)
        state.total_steps += 1

    return [("rollout (K1 x max_depth)", roll),
            ("regather (K2) + learner loss", loss),
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
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    tree = tree_lib.generate_tree(DEMO_TREE, seed=0, device="cuda")
    cfg = RNaDConfig(batch_size=BATCH_SIZE, eta=0.2, lr=1e-3,
                     gamma_averaging=0.01, logit_clip=2.0)
    run = rnad.RNaD(tree, cfg, NetConfig(type="MLP", max_actions=3,
                                         width=WIDTH))
    run.initialize()
    for _ in range(3):
        run.train_step(run.state, 1.0)
    torch.cuda.synchronize()

    phases = phase_ms(run)
    step = sum(phases.values())
    print(f"train step at B={BATCH_SIZE}, width {WIDTH}: "
          f"{step:.4f} ms device time | {card}")
    for name, ms in phases.items():
        print(f"  {name:32s} {ms:9.4f} ms  {100 * ms / step:5.1f} %")
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
