"""Where a train step's time goes on the card.

    python3 -m rnad_tpu_torch.profile_step \
        [--net mlp|equinet|flagship|offpol|convnet] \
        [--fuse-net-passes off|heads|auto] [--flat-optimizer]

``--fuse-net-passes`` and ``--flat-optimizer`` set the learner step's
options on any config, so its phases and kernel count can be read for
each variant.  The learner runs one layout, (T, B, A), so there is no
layout option.

``--net mlp`` (the default) builds the demo tree (eta_sweep's config, seed
0) and the MLP path's ``RNaD`` trainer (32768 lanes, MLP width 256).
``--net equinet`` builds the EquiNet path of ``chip_smoke.py``: the A = 5
tree (65440 nodes, seed 0) and the solver-primed EquiNet (64 channels,
depth 2, 128 RM+ iterations, float32) at 32768 lanes.  ``--net flagship``
builds flagship-3's path (``docs/runs/r4-flagship3.params.json``): the
native generator's 785,768-node A = 5 depth-6 tree and the same EquiNet in
bfloat16, with flagship-3's R-NaD settings, at 32768 lanes.  ``--net
offpol`` builds r5-offpol-32k (``docs/runs/r5-offpol-32k.params.json``): the
same tree, a width-256 MLP at 32768 lanes and the replay buffer (4 slots, a
rollout every 2 learner steps).  ``--net convnet`` builds r5-noisy-conv
(``docs/runs/r5-noisy-conv.params.json``): the train CLI's default tree
(A = 3, depth 4, seed 0), the noisy lift (8 channels, sigma 0.15) and the
ConvNet 16x2 with BatchNorm at 512 lanes.  It warms up, then times one
train step split into its phases with CUDA events (rollout, for the
buffered step its sampling and collate, the regather where the rollout
stores no observations (``store_rollout_obs=False``) and the solver
features of a solver EquiNet, learner and frozen passes with the loss,
backward, clip + Adam + EMA), each
phase's events recorded after its own sleep kernel that hides the host's
enqueue time; the buffered step rolls out on every second step, so its rollout
phase is the mean over steps with and without one.  Then it traces a few
steps with ``torch.profiler`` and prints the device time by kernel.  Needs
a CUDA card; prints the card's name and power limit beside the numbers.

For the MLP configurations (``mlp`` and ``offpol``) it prints beside each
phase its bound on the H100 SXM's published peaks (``roofline.py``: the
work of the phase's function from its shapes and from the distinct rows
and cells of the timed steps' trajectories), which side binds and the
share of the bound in the measured time; then the whole step's bound
against its device time and its back-to-back time.  The other nets have
no roofline model, as in ``tools/roofline.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import tempfile
import time
from typing import Optional

import torch

from . import roofline
from .config import (NetConfig, ObsTransformConfig, RNaDConfig, ShapingRule,
                     TreeConfig)
from .env import tree as tree_lib
from .learn import buffer as buffer_lib
from .learn import rnad
from .models import nets
from .utils import timing

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
    "offpol": (FLAGSHIP_TREE,
               NetConfig(type="MLP", max_actions=5, width=256),
               RNaDConfig(batch_size=BATCH_SIZE, eta=0.2, lr=5e-4,
                          gamma_averaging=0.001, n_batches_per_buffer=4,
                          buffer_mod=2)),
    "convnet": (TreeConfig(max_actions=3, max_transitions=2,
                           transition_threshold=0.3, depth_bound=4),
                NetConfig(type="ConvNet", max_actions=3, channels=16,
                          depth=2),
                RNaDConfig(batch_size=512, eta=0.2, lr=1e-3,
                           gamma_averaging=0.01, logit_clip=2.0,
                           obs_transform=ObsTransformConfig(
                               kind="lift", channels=8, sigma=0.15))),
}
NATIVE = ("flagship", "offpol")  # trees of the native generator


def variant(cfg: RNaDConfig, fuse_net_passes: Optional[str] = None,
            flat_optimizer: bool = False) -> RNaDConfig:
    """``cfg`` with the learner step's options that are given."""
    kw = {"fuse_net_passes": fuse_net_passes,
          "flat_optimizer": flat_optimizer or None}
    return dataclasses.replace(cfg, **{k: v for k, v in kw.items()
                                       if v is not None})


def _buffered(run: rnad.RNaD) -> bool:
    return run.cfg.n_batches_per_buffer > 1 or run.cfg.buffer_mod > 1


def _phases(run: rnad.RNaD, alpha: float, buffer=None):
    """One train step as (name, thunk) phases, in train_step's order; with
    a ``buffer``, the buffered step's (``RNaD.buffered_step``).  Also
    returns the dict in which the phases leave the step's rollout
    ("rollout", where the step rolled out) and learner batch ("traj")."""
    state, cfg = run.state, run.cfg
    box = {}

    def roll():
        traj = rnad.rollout(state, run.tree, run.packed, cfg,
                            obs_transform=run.obs_transform)
        box["traj"] = box["rollout"] = traj

    def roll_if_due():
        if state.total_steps % cfg.buffer_mod == 0:
            box["rollout"] = rnad.rollout(state, run.tree, run.packed, cfg)
            buffer.append(box["rollout"])

    def collate():
        box["traj"] = buffer.sample(cfg.batch_size, run._np_rng)

    def inputs():
        box["inputs"] = rnad.learner_inputs(state, run.packed, box["traj"])

    def loss():  # without an inputs phase it reads the stored observations
        box["loss"], _ = rnad.learn_loss(state, run.packed, box["traj"],
                                         alpha, cfg,
                                         inputs=box.get("inputs"))

    def backward():
        box["grads"] = torch.autograd.grad(box["loss"],
                                           list(state.net.parameters()))

    def update():
        rnad.apply_update(cfg, state, box["grads"])
        state.total_steps += 1

    first = ([("rollout", roll)] if buffer is None else
             [("rollout (every buffer_mod-th step)", roll_if_due),
              ("sample + collate", collate)])
    # the learner's inputs: a phase where they take work, the regather of
    # unstored observations (K2) or the solve (K3)
    solve = isinstance(state.net, nets.EquiNet) and state.net.solver_iters
    work = (["regather (K2)"] * (not cfg.store_rollout_obs)
            + ["EquiNet solve (K3)"] * bool(solve))
    if work:
        first.append((", ".join(work), inputs))
    return first + [
            ("learner + frozen passes, v-trace, loss", loss),
            ("backward", backward), ("clip + Adam + EMA", update)], box


def phase_ms(run: rnad.RNaD, iters: int = 10, buffer=None):
    """Device ms of each phase, mean over ``iters`` steps, and the steps'
    mean ``roofline.Counts`` (the rollouts' over the steps that rolled
    out)."""
    names = [n for n, _ in _phases(run, 1.0, buffer)[0]]
    total = {n: 0.0 for n in names}
    rolls, learner_rows = [], []
    for _ in range(iters):
        # a sleep before each phase: the launch queue holds about a
        # thousand kernels, fewer than a whole step of the small nets
        # launches, so one sleep per step would not hide the host
        phases, box = _phases(run, 1.0, buffer)
        for name, fn in phases:
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)  # ~0.1 s: covers the enqueue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total[name] += start.elapsed_time(end) / iters
        if "rollout" in box:
            rolls.append(roofline.Counts.of(box["rollout"]))
        learner_rows.append(
            roofline.Counts.of(box["traj"]).learner_rows)
    mean = lambda xs: sum(xs) / len(xs)
    counts = roofline.Counts(mean([c.rollout_rows for c in rolls]),
                             mean([c.rollout_cells for c in rolls]),
                             mean(learner_rows))
    return total, counts


def roofline_rows(run: rnad.RNaD, phases, counts: roofline.Counts):
    """``roofline.annotate`` of each phase's work against its measured ms
    (``phases``, as ``phase_ms`` returns them), and the step's whole work;
    raises ValueError for a net the roofline does not model."""
    tree = run.tree
    step = roofline.MLPStep.of(run.cfg, run.net_config, tree.max_actions,
                               tree.max_transitions, tree.max_depth)
    works = roofline.step_phases(step, counts)
    if len(works) != len(phases) or not all(
            name.startswith(w) for name, (w, _) in zip(phases, works)):
        raise AssertionError(f"roofline phases {[w for w, _ in works]} "
                             f"are not the step's {list(phases)}")
    rows = {name: roofline.annotate(work, phases[name])
            for name, (_, work) in zip(phases, works)}
    return rows, roofline.total(works)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", choices=sorted(CONFIGS), default="mlp")
    parser.add_argument("--fuse-net-passes", default=None,
                        choices=["off", "heads", "auto"],
                        help="override the config's net-pass strategy "
                             "('heads' for the MLP only); rnad_tpu's packed "
                             "'frozen' and 'all' lost to 'heads' on the TPU "
                             "and on the H100, and the port does not run "
                             "them")
    parser.add_argument("--flat-optimizer", action="store_true",
                        help="clip + Adam + EMA on one raveled vector")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    tree_cfg, net_cfg, cfg = CONFIGS[args.net]
    cfg = variant(cfg, args.fuse_net_passes, args.flat_optimizer)
    gen = (tree_lib.generate_tree_native if args.net in NATIVE
           else tree_lib.generate_tree)
    tree = gen(tree_cfg, seed=0, device="cuda")
    runs = tempfile.TemporaryDirectory(prefix="profile_step_")
    run = rnad.RNaD(tree, cfg, net_cfg, directory_name=args.net,
                    runs_root=runs.name)
    run.initialize()
    buffer = None
    if _buffered(run):
        buffer = buffer_lib.TrajectoryBuffer(cfg.n_batches_per_buffer)
        train_step = lambda: run.buffered_step(buffer, 1.0)
    else:
        train_step = lambda: run.train_step(run.state, 1.0)
    for _ in range(2 * cfg.n_batches_per_buffer * cfg.buffer_mod):
        train_step()  # warm-up; fills the buffer
    torch.cuda.synchronize()

    phases, counts = phase_ms(run, buffer=buffer)
    step = sum(phases.values())
    bounds, work = {}, None
    if net_cfg.type == "MLP" and cfg.obs_transform.kind == "none":
        bounds, work = roofline_rows(run, phases, counts)
    print(f"train step at B={cfg.batch_size}, {net_cfg}, fuse_net_passes "
          f"{cfg.fuse_net_passes}, flat optimizer {rnad.uses_flat_optimizer(cfg, run.state)}, "
          f"obs_transform "
          f"{cfg.obs_transform.kind}, buffer {cfg.n_batches_per_buffer} "
          f"slots / mod {cfg.buffer_mod}: {step:.4f} ms device time; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
          f"{card}")
    if work is None:
        print("no roofline model (tools/roofline.py models the MLP towers "
              "only)")
    for name, ms in phases.items():
        bound = bounds.get(name)
        print(f"  {name:40s} {ms:9.4f} ms  {100 * ms / step:5.1f} %" + (
            "" if bound is None else
            f"  bound {bound['bound_ms']:.6f} ms ({bound['bound']}), "
            f"{bound['pct_of_roof']:.3f} % of it"))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):  # the host-bound time spreads: median of 3 runs
        start.record()
        for _ in range(10):
            train_step()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 10)
    back_to_back = sorted(runs)[1]
    print(f"back-to-back steps: {back_to_back:.4f} ms per step (runs "
          + "/".join(f"{r:.4f}" for r in runs) + " ms), so the device idles "
          f"{100 * (1 - step / back_to_back):.1f} % of it waiting for the "
          "host's launches")
    if work is not None:
        on_device = roofline.annotate(work, step)
        print(f"roofline: the step's bound {on_device['bound_ms']:.6f} ms "
              f"({on_device['bound']}; {on_device['gflops']:.6g} GFLOP, "
              f"{on_device['gbytes']:.6g} GB; distinct rows a rollout "
              f"{counts.rollout_rows:.1f}, cells {counts.rollout_cells:.1f},"
              f" learner rows {counts.learner_rows:.1f}) is "
              f"{on_device['pct_of_roof']:.3f} % of the device time and "
              f"{roofline.annotate(work, back_to_back)['pct_of_roof']:.3f} %"
              f" of the back-to-back time | {card}")

    steps = 6  # a whole number of buffer_mod periods
    with timing.trace() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step()
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
