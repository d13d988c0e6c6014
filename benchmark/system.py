"""The system under test: the port's ``RNaD`` built for a cell, and what
every traffic kind's driver (``drivers/<kind>.py``) shares.

Everything the program receives is made here from the seed: the game tree
(``trees.py``); from one generator on the card, seeded with the weight
seed, the initial weights of all four nets (one draw, each leaf scaled to
its layer's initial range), then where the net keeps state (BatchNorm's
running averages) that state (a second draw), then where the
configuration lifts its observations the lift's fixed ``mix`` (C, 2) ~
N(0, 1) / sqrt(2) and ``bias`` (C, A, A) ~ ``bias_scale`` N(0, 1), the JAX
package's scales; and the rollout noise (the state's generator, seeded
with the noise seed).  The reference (``reference/``) gets the same tree
arrays, weights, state, lift and noise seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trees
from .reference import nets as ref_nets
from .reference.rnad import alpha_schedule


def seeds(seed: int):
    """(weight seed, noise seed) of a run seed of any size."""
    mixed = (seed * 0x9E3779B97F4A7C15) % (1 << 62)
    return mixed, mixed + 1


def make_weights(net: dict, A: int, gen: torch.Generator,
                 in_channels: int = 2) -> Dict[str, torch.Tensor]:
    """Every leaf of ``net`` from ``gen``: one uniform draw of the trained
    leaves, U(-b, b) at its layer's initial range b, gates and BatchNorm
    scales at 1 and BatchNorm biases at 0; then, where the net keeps state,
    a second draw of it, U(low, high) each.  The EquiNet's heads are drawn
    too, not zero as the published priming starts them: with zero heads
    the tower's first gradient is exactly zero, and the check would not
    see the tower's backward."""
    device = gen.device
    out = {}
    for shapes in (ref_nets.param_shapes(net, A, in_channels),
                   ref_nets.state_shapes(net, A, in_channels)):
        if not shapes:
            continue
        sizes = [math.prod(s) for _, s, _ in shapes]
        flat = torch.rand((sum(sizes),), generator=gen, device=device)
        for (name, shape, span), part in zip(shapes, flat.split(sizes)):
            part = part.reshape(shape)
            if isinstance(span, tuple):
                out[name] = span[0] + part * (span[1] - span[0])
            elif span is None:
                out[name] = torch.ones(shape, device=device)
            elif span == 0:
                out[name] = torch.zeros(shape, device=device)
            else:
                out[name] = (part * 2 - 1) * span
    return out


def make_lift(config: dict, A: int, gen: torch.Generator
              ) -> Optional[Dict[str, torch.Tensor]]:
    """The lift's ``mix`` and ``bias`` from ``gen``, where the
    configuration lifts its observations; else None."""
    lift = config["rnad"].get("obs_transform", {})
    if lift.get("kind") != "lift":
        return None
    C = lift["channels"]
    mix = torch.randn((C, 2), generator=gen, device=gen.device) / math.sqrt(
        2.0)
    bias = lift["bias_scale"] * torch.randn((C, A, A), generator=gen,
                                            device=gen.device)
    return {"mix": mix, "bias": bias}


@dataclasses.dataclass
class System:
    """The port's trainer for one cell and run seed, and the inputs it was
    given."""

    trainer: object  # rnad_tpu_torch.learn.rnad.RNaD
    arrays: Dict[str, np.ndarray]
    params0: Dict[str, torch.Tensor]
    noise_seed: int
    delta_m: int
    tree_generated: bool
    tree_s: float
    store: str
    lift: Optional[Dict[str, torch.Tensor]] = None
    steps: int = 0  # train steps taken, the alpha schedule's n

    @property
    def state(self):
        return self.trainer.state

    @property
    def inputs(self):
        """What the reference is handed: the tree's arrays, the initial
        weights and state, the noise seed and the lift (or None)."""
        return self.arrays, self.params0, self.noise_seed, self.lift

    def step(self, with_trajectory: bool = False):
        """One ``RNaD.train_step`` at the schedule's alpha."""
        alpha = alpha_schedule(self.steps, self.delta_m)
        self.steps += 1
        return self.trainer.train_step(self.state, alpha,
                                       with_trajectory=with_trajectory)

    def close(self) -> None:
        self.trainer = None
        shutil.rmtree(self.store, ignore_errors=True)


def build(config: dict, lanes: int, seed: int, device="cuda") -> System:
    """Tree, ``RNaD`` (initialized, its run store under ``TMPDIR``),
    weights and noise of one run."""
    from rnad_tpu_torch.config import NetConfig, RNaDConfig
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.learn import rnad as rnad_lib

    arrays, generated, tree_s = trees.make_tree(config["tree"])
    meta = {"max_actions": config["tree"]["max_actions"],
            "max_transitions": config["tree"]["max_transitions"],
            "max_depth": int(arrays["depth"][1]), "hash": 0}
    tree = tree_lib.tree_from_arrays(arrays, meta, device)
    cfg = RNaDConfig.from_json(dict(config["rnad"], batch_size=lanes))
    net_cfg = NetConfig.from_json(config["net"])
    store = tempfile.mkdtemp(prefix="rnad-bench-")
    trainer = rnad_lib.RNaD(tree, cfg, net_cfg, directory_name="run",
                            runs_root=store, device=device)
    trainer.initialize()
    weight_seed, noise_seed = seeds(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(weight_seed)
    params0 = make_weights(config["net"], tree.max_actions, gen,
                           ref_nets.in_channels(config))
    lift = make_lift(config, tree.max_actions, gen)
    state = trainer.state
    for net in (state.net, state.net_target, state.net_reg, state.net_reg_):
        net.load_state_dict(params0, strict=True)
    if lift is not None:
        with torch.no_grad():
            trainer.obs_transform.mix.copy_(lift["mix"])
            trainer.obs_transform.bias.copy_(lift["bias"])
    state.generator.manual_seed(noise_seed)
    return System(trainer, arrays, params0, noise_seed, cfg.delta_m[0],
                  generated, tree_s, store, lift)


@contextlib.contextmanager
def recorded_solves(records: list):
    """Records every RM+ solve of the program (``solver_device.
    solve_zero_sum_rmplus``, which the EquiNet's features call at each
    use): its payoffs, legal rows and columns and its answer, on the
    host."""
    from rnad_tpu_torch.env import solver_device

    solve = solver_device.solve_zero_sum_rmplus

    def recording(M, lr, lc, iters=2000):
        out = solve(M, lr, lc, iters=iters)
        records.append(tuple(t.detach().float().cpu()
                             for t in (M, lr, lc) + tuple(out)))
        return out

    solver_device.solve_zero_sum_rmplus = recording
    try:
        yield
    finally:
        solver_device.solve_zero_sum_rmplus = solve


# top-level module names that no process of the benchmark may load: JAX
# and the JAX package (the port's name begins with the latter's)
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "rnad_tpu"))


def forbidden_loaded(modules) -> List[str]:
    """The forbidden top-level names among ``modules``, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def free(system: System) -> None:
    """Drops the program's state and its run store, and returns the
    card's cached blocks."""
    system.close()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
