"""Learner-step throughput matrix: the net-pass strategy x dtype, and the
raveled optimizer tail, at one batch.

Counterpart of ``tools/learner_probe.py``.

    python3 -m rnad_tpu_torch.learner_probe [--batch 32768] [--iters 256] \\
        [--width 256] [--only PATTERNS] [--tree demo|NAME] \\
        [--vtrace scan,associative] [--cpu]

For each of the tool's labelled configs that the port runs, 8 of its 16
(``fuse_net_passes`` off and heads; the MLP and its frozen passes in
float32 or bfloat16; "light" turns the detailed metrics off, "flat" is
``flat_optimizer``; the tool's "frozen", "all" and "amb" rows are
``rnad_tpu`` strategies that ``learn/rnad.py::check_supported`` refuses,
as they lost or tied on the TPU and on the H100), it times the fused
train step (``make_train_step``: rollout, regather, learner and frozen
passes, v-trace, losses, clip + Adam, EMA) of the width-``--width`` MLP at
``--batch`` lanes on the demo tree (``bench.TREE_CONFIG``, the tool's) or
on a tree of the port's tree store (``--tree NAME``, read from
``saved_trees/`` under the working directory).  ``--only`` keeps the
configs whose label contains one of its comma-separated patterns (a
pattern ending in ``$`` must equal the label); ``--vtrace`` crosses every
selected config with each named v-trace mode (labels ``config@mode``).

Each config starts from the same state (the nets drawn from seed 0, the
rollout noise from seed 1; the tool's ``PRNGKey(0)``), warms up on
another (seed 9), then runs ``--iters`` steps back to back under a host
clock that ends in one fetch of their losses, as ``bench.py`` times the
product.  Self-checks, each of which raises: every loss is finite; the
first step's loss equals the split program's (``rollout`` then
``learn_step`` from a copy of the state) within rtol 1e-5 and atol 1e-6;
and it is within rtol 1e-5 of the "off" config's at the same dtypes and
v-trace mode, from the same state and noise (that one-step reference runs
untimed when "off" is not selected).  torch has no scan of steps, so the
tool's scan and its miscompile fallback are left out, as ``bench.py``
leaves them out: every row's ``method`` is "back-to-back".

Prints a header line, one JSON row a config (``config``,
``updates_per_s``, ``ms_per_step``, ``method``, ``loss0``, ``flat``:
whether the raveled tail ran under ``rnad_tpu``'s ``use_flat`` rule,
``k1_per_step`` and ``k2_per_step``: the kernels' launches a timed step,
counted on the card only, ``device``, ``power_limit_w``), then the tool's
"x vs off" summary.  Runs on the card unless ``--cpu`` is given, and
without a card exits nonzero before printing anything.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import bench
from .config import NetConfig, RNaDConfig
from .env import tree as tree_lib
from .learn import rnad
from .models import nets
from .ops import fused_turn, lookup, stepping
from .utils import checkpoint

# (label, net compute dtype, frozen dtype, fuse mode[-modifiers]), the
# tool's
COMBOS = [
    ("f32/off", "float32", "float32", "off"),
    ("f32/heads", "float32", "float32", "heads"),
    ("f32+frozenbf16/off", "float32", "bfloat16", "off"),
    ("f32+frozenbf16/heads", "float32", "bfloat16", "heads"),
    ("bf16/off", "bfloat16", "bfloat16", "off"),
    ("bf16/heads", "bfloat16", "bfloat16", "heads"),
    ("bf16/heads-light", "bfloat16", "bfloat16", "heads-light"),
    ("f32/heads-flat", "float32", "float32", "heads-flat"),
]
NET_SEED, NOISE_SEED, WARM_SEED = 0, 1, 9
ALPHA = 0.5
RTOL, ATOL = 1e-5, 1e-6

Combo = Tuple[str, str, str, str, str]  # ... and the v-trace mode


def select(only: Optional[str], vtrace: Optional[str]) -> List[Combo]:
    """The configs ``--only`` and ``--vtrace`` select, in the tool's
    order."""
    combos = COMBOS
    if only:
        pats = only.split(",")
        match = lambda lbl: any((lbl == p[:-1]) if p.endswith("$")
                                else (p in lbl) for p in pats)
        combos = [c for c in combos if match(c[0])]
    if vtrace:
        return [(f"{label}@{vm}", nd, fd, fuse, vm)
                for vm in vtrace.split(",")
                for (label, nd, fd, fuse) in combos]
    return [c + ("auto",) for c in combos]


def configs(combo: Combo, batch: int, width: int, A: int
            ) -> Tuple[RNaDConfig, NetConfig]:
    """The tool's ``RNaDConfig`` and MLP of one config."""
    _, net_dtype, frozen_dtype, fuse, vtrace_mode = combo
    fuse, *mods = fuse.split("-")
    if not set(mods) <= {"light", "flat"}:
        raise ValueError(f"unknown modifiers {mods}")
    cfg = RNaDConfig(batch_size=batch, eta=0.2, bounds=(1,), delta_m=(1,),
                     lr=1e-3, gamma_averaging=0.01, logit_clip=2.0,
                     frozen_net_dtype=frozen_dtype, fuse_net_passes=fuse,
                     detailed_metrics="light" not in mods,
                     flat_optimizer="flat" in mods, vtrace_mode=vtrace_mode)
    return cfg, NetConfig(type="MLP", max_actions=A, width=width,
                          compute_dtype=net_dtype)


def fresh_state(net_cfg: NetConfig, device, seed: int) -> rnad.TrainState:
    """The nets drawn from ``seed``, the rollout noise from ``seed + 1``."""
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(seed))
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return rnad.init_train_state(net.to(device), generator)


def clone_state(state: rnad.TrainState) -> rnad.TrainState:
    """A copy of ``state`` whose noise generator continues where
    ``state``'s does."""
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return rnad.TrainState(
        net=copy.deepcopy(state.net), net_target=copy.deepcopy(
            state.net_target), net_reg=copy.deepcopy(state.net_reg),
        net_reg_=copy.deepcopy(state.net_reg_),
        opt=copy.deepcopy(state.opt), generator=generator,
        total_steps=state.total_steps)


def split_loss(state: rnad.TrainState, tree: tree_lib.GameTree,
               packed: stepping.PackedTables, cfg: RNaDConfig) -> float:
    """The first step's loss from a copy of ``state`` through the split
    program: ``rollout``, then ``learn_step``."""
    ref = clone_state(state)
    traj = rnad.rollout(ref, tree, packed, cfg)
    return float(rnad.learn_step(ref, packed, traj, ALPHA, cfg)["loss"])


def _close(a: float, b: float, rtol: float, atol: float = 0.0) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def measure(combo: Combo, tree: tree_lib.GameTree,
            packed: stepping.PackedTables, batch: int, width: int,
            iters: int, off_loss: float, card: Dict) -> Dict:
    """One config's row; raises where a self-check fails."""
    label = combo[0]
    device = tree.device
    cfg, net_cfg = configs(combo, batch, width, tree.max_actions)
    rnad.check_supported(cfg, net_cfg)
    state = fresh_state(net_cfg, device, NET_SEED)
    rnad.resolve_fuse_mode(state.net, cfg)
    loss_ref = split_loss(state, tree, packed, cfg)
    train_step = rnad.make_train_step(tree, packed, cfg)
    warm = fresh_state(net_cfg, device, WARM_SEED)
    for _ in range(bench.WARM_STEPS):
        train_step(warm, ALPHA)
    del warm
    bench.synchronize(device)
    k1, k2 = fused_turn.fused_turn.launches, lookup.lookup.launches
    t0 = time.perf_counter()
    losses = torch.stack([train_step(state, ALPHA)[1]["loss"]
                          for _ in range(iters)]).cpu()
    dt = (time.perf_counter() - t0) / iters
    k1 = (fused_turn.fused_turn.launches - k1) / iters
    k2 = (lookup.lookup.launches - k2) / iters
    loss0 = float(losses[0])
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite loss {losses.tolist()}")
    if not _close(loss0, loss_ref, RTOL, ATOL):
        raise AssertionError(f"{label}: first step's loss {loss0!r} is not "
                             f"the split program's {loss_ref!r}")
    if not _close(loss0, off_loss, RTOL):
        raise AssertionError(f"{label}: first step's loss {loss0!r} is not "
                             f"within rtol {RTOL} of 'off' ({off_loss!r})")
    return {"config": label, "updates_per_s": 1.0 / dt,
            "ms_per_step": dt * 1e3, "method": "back-to-back",
            "loss0": loss0, "flat": rnad.uses_flat_optimizer(cfg, state),
            "k1_per_step": k1, "k2_per_step": k2, **card}


def off_of(combo: Combo) -> Combo:
    """The "off" config at ``combo``'s dtypes and v-trace mode."""
    label, net_dtype, frozen_dtype, _, vtrace_mode = combo
    prefix, _, rest = label.partition("/")
    suffix = rest.partition("@")[1] + rest.partition("@")[2]
    return (f"{prefix}/off{suffix}", net_dtype, frozen_dtype, "off",
            vtrace_mode)


def summary(results: Dict[str, float]) -> List[str]:
    """The tool's "x vs off" lines: each rate over its dtype's "off" (f32
    for every label not starting with bf16) at the same v-trace mode."""
    lines = []
    for label, rate in results.items():
        prefix = "bf16" if label.startswith("bf16") else "f32"
        mode = label.partition("@")[1] + label.partition("@")[2]
        base = results.get(f"{prefix}/off{mode}")
        if base:
            lines.append(f"# {label}: {rate:8.1f}/s  ({rate / base:.3f}x "
                         "vs off)")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parses ``argv`` (default: the command line), prints the rows and
    the summary, and returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--iters", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--only", default=None,
                   help="comma-separated substrings; run only matching "
                        "configs (e.g. 'heads,off')")
    p.add_argument("--tree", default="demo",
                   help="'demo' or the name of a tree in the port's tree "
                        "store (saved_trees/ under the working directory)")
    p.add_argument("--vtrace", default=None,
                   help="comma list of vtrace modes to cross with every "
                        "selected config (scan,associative); default: the "
                        "config default ('auto')")
    args = p.parse_args(argv)
    device = bench.setup(args.cpu, "learner_probe")
    if args.tree == "demo":
        tree = tree_lib.generate_tree(bench.TREE_CONFIG, seed=0,
                                      device=device)
    else:
        tree = checkpoint.load_tree(args.tree, device=device)
    packed = stepping.make_packed_tables(tree)
    card = bench.card(device)
    print(f"tree={tree.size} depth={tree.max_depth} batch={args.batch} "
          f"device={card['device']} power_limit_w={card['power_limit_w']}",
          flush=True)
    rows, rates, off_losses = [], {}, {}
    for combo in select(args.only, args.vtrace):
        off = off_of(combo)
        if off[0] not in off_losses:
            cfg, net_cfg = configs(off, args.batch, args.width,
                                   tree.max_actions)
            off_losses[off[0]] = split_loss(
                fresh_state(net_cfg, device, NET_SEED), tree, packed, cfg)
        row = measure(combo, tree, packed, args.batch, args.width,
                      args.iters, off_losses[off[0]], card)
        rows.append(row)
        rates[row["config"]] = row["updates_per_s"]
        print(json.dumps(row), flush=True)
    for line in summary(rates):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
