"""The least time one H100 could take for the MLP family's train step, by
phase: the counterpart of ``tools/roofline.py``.

Each phase of ``profile_step.py``'s table (rollout, or for the buffered
step the rollout every ``buffer_mod``-th step and the sample + collate;
the regather where the rollout stores no observations; learner + frozen
passes, v-trace and loss; backward; clip + Adam + EMA) gets a ``Work``:
its matmul products by operand type and the bytes it must move through
HBM.  ``annotate`` sets a measured time against the
larger of the two floors, ``Work.ops_s`` (products over the card's peak
rate for their type) and ``Work.bytes_s`` (bytes over the HBM rate).  The
counts come from the function's shapes, not from what an implementation
launches, so swapping the implementation of a phase cannot move its own
yardstick.

It models what ``tools/roofline.py`` models: the two-head MLP
(``nets.MLP``, any depth, float32 or bfloat16), its rollout, the fused
on-policy step and the buffered step.  Its conventions carry over:

- operations are the matmul products only, an FMA counting two; the
  elementwise work (v-trace, the losses, Adam) is charged by its bytes;
- the frozen passes run in "heads" mode: the target's value tower and the
  regularization pair's policy towers (:160-164), plus the target's policy
  tower that the learner's detailed metrics read (``detailed_metrics``);
- the learner reads the observations and masks once (:155-157); with
  ``store_rollout_obs`` (the default) the rollout writes each lane's two
  observations as K1's output and the step has no regather, whose bytes
  the TPU tool charges to the learner; each net pass writes and reads
  its inputs and outputs once, ``2 din + A + 1`` elements a sample
  (:130, :166); v-trace makes 24 passes over (T, B, A) float32 (:167).

It departs from them in three places:

- **Ideal products only.** No MXU tile padding, no dead table lanes, no
  block-diagonal zeros: the rollout's products are K1's own
  ``ops/fused_turn.py::operations``, which equal the generic per-seat
  forward's.  The backward counts what the gradients of the parameters
  need: every layer's weight gradient and the input gradient of every
  layer but the first, whose input (the observation) takes no gradient.
  ``tools/roofline.py`` also charges that first input gradient
  (``backward_matmuls``); autograd never computes it, and at A = 3 it is
  45 % of the backward's products.
- **Each product is charged at its operand type's rate**: float32 at 67
  TFLOP/s on the CUDA cores and bfloat16 at 989 TFLOP/s on the tensor
  cores.  Every path of the port keeps TF32 off (``RNaD.__init__``), so a
  float32 product is a float32 product; XLA:TPU fed the MXU bfloat16
  operands for float32 arrays, which is why the TPU tool charged the bf16
  rate for both (:175-185).
- **Gathers count distinct rows.** The phases that read the packed table
  (the rollout and the regather) read each distinct state's row once,
  and the rollout each distinct played (state, joint action) cell's
  transition once, as ``fused_turn.io_bytes`` and K2's bound in
  ``chip_smoke.py`` do.  The counts depend on the data: ``Counts.of``
  takes them from a trajectory.

Peaks are NVIDIA's published dense rates of the H100 SXM at its 700 W
limit; a card set below that limit runs slower under load, so a share is
stated with the card's power limit beside it.

    python -m rnad_tpu_torch.roofline [--net mlp|offpol] [--batch-size N]

prints the counts of ``profile_step.py``'s configuration and the bound on
these peaks, with every lane's row charged as distinct (no trajectory is
drawn): counts from shapes, not a device measurement.  ``profile_step.py``
prints the bound beside each phase's measured time on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .ops import fused_turn


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's dense peak rates: products a second by operand type and
    HBM bytes a second."""

    flops_bf16: float
    flops_tf32: float
    flops_f32: float
    hbm_bytes_per_s: float

    def flops(self, dtype: str) -> float:
        return {"bfloat16": self.flops_bf16, "tf32": self.flops_tf32,
                "float32": self.flops_f32}[dtype]


# NVIDIA's H100 SXM data sheet: dense (no sparsity), at the 700 W limit
H100_SXM = Peaks(flops_bf16=989e12, flops_tf32=495e12, flops_f32=67e12,
                 hbm_bytes_per_s=3.35e12)


@dataclasses.dataclass(frozen=True)
class Work:
    """Matmul products (FLOPs, an FMA counting two) by operand type, and
    the bytes that must cross HBM."""

    flops: Dict[str, float]
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        flops = dict(self.flops)
        for dtype, f in other.flops.items():
            flops[dtype] = flops.get(dtype, 0.0) + f
        return Work(flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work({d: k * f for d, f in self.flops.items()}, k * self.bytes)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def ops_s(self, peaks: Peaks = H100_SXM) -> float:
        return sum(f / peaks.flops(d) for d, f in self.flops.items())

    def bytes_s(self, peaks: Peaks = H100_SXM) -> float:
        return self.bytes / peaks.hbm_bytes_per_s

    def bound_s(self, peaks: Peaks = H100_SXM) -> float:
        return max(self.ops_s(peaks), self.bytes_s(peaks))


def annotate(work: Work, measured_ms: float, peaks: Peaks = H100_SXM
             ) -> dict:
    """The bound of ``work`` against a measured time, under the names of
    ``tools/roofline.py::annotate``: ``bound_ms``, ``bound`` ("hbm" or
    "ops", the side that binds), ``pct_of_roof`` (the bound over the
    time), ``pct_of_hbm`` (the byte floor alone) and ``pct_of_sum`` (the
    sum of both floors: the bound where nothing overlaps the products
    with the bytes; it may pass 100 %).  Raises where ``pct_of_roof``
    passes 100 %: no run beats its bound, so a count is wrong."""
    if not measured_ms > 0:
        raise ValueError(f"measured time {measured_ms} ms is not positive")
    ops_ms, hbm_ms = 1e3 * work.ops_s(peaks), 1e3 * work.bytes_s(peaks)
    out = {"bound_ms": max(ops_ms, hbm_ms),
           "bound": "hbm" if hbm_ms >= ops_ms else "ops",
           "pct_of_roof": 100.0 * max(ops_ms, hbm_ms) / measured_ms,
           "pct_of_hbm": 100.0 * hbm_ms / measured_ms,
           "pct_of_sum": 100.0 * (ops_ms + hbm_ms) / measured_ms,
           "gflops": work.total_flops / 1e9, "gbytes": work.bytes / 1e9}
    if out["pct_of_roof"] > 100.0:
        raise ValueError(f"{measured_ms} ms beats its bound of "
                         f"{out['bound_ms']} ms: the work is miscounted")
    return out


Matmul = Tuple[int, int, int]  # (M rows, K contraction, N columns)


def matmul_flops(ms: List[Matmul]) -> float:
    return float(sum(2 * M * K * N for M, K, N in ms))


def mlp_forward_matmuls(n: int, A: int, width: int, depth: int = 1,
                        heads: Optional[Tuple[int, ...]] = None
                        ) -> List[Matmul]:
    """The matmuls of ``n`` samples through ``nets.MLP``'s towers (output
    widths ``heads``, default both: policy A and value 1), each tower
    ``fc0``, ``depth - 1`` hidden layers and ``fc1``;
    ``tools/roofline.py::mlp_forward_matmuls`` with hidden layers."""
    din = 2 * A * A
    ms: List[Matmul] = []
    for out in (heads if heads is not None else (A, 1)):
        ms.append((n, din, width))
        ms += [(n, width, width)] * (depth - 1)
        ms.append((n, width, out))
    return ms


def mlp_backward_matmuls(n: int, A: int, width: int, depth: int = 1
                         ) -> List[Matmul]:
    """The gradients of the parameters of both towers over ``n`` samples:
    each layer's weight gradient X^T dY (K, M, N) and the input gradient
    dY W^T (M, N, K) of every layer but ``fc0``."""
    ms: List[Matmul] = []
    per_tower = depth + 1
    for i, (M, K, N) in enumerate(mlp_forward_matmuls(n, A, width, depth)):
        ms.append((K, M, N))
        if i % per_tower:
            ms.append((M, N, K))
    return ms


def mlp_params(A: int, width: int, depth: int = 1) -> int:
    """Parameters of ``nets.MLP``: weights and biases of both towers."""
    return sum(K * N + N for _, K, N in mlp_forward_matmuls(1, A, width,
                                                          depth))


@dataclasses.dataclass(frozen=True)
class Counts:
    """The data-dependent counts of one step: distinct states the rollout's
    turns read, distinct (state, joint action) cells they played, and
    distinct states the learner's batch regathers."""

    rollout_rows: float
    rollout_cells: float
    learner_rows: float

    @staticmethod
    def of(rollout, learner=None) -> "Counts":
        """From trajectories (``engine.Trajectory``): the rollout's, and
        the learner's batch (the collated sample of a buffered step;
        default the rollout's)."""
        learner = rollout if learner is None else learner
        A = rollout.num_actions
        turns = rollout.indices[0::2].long()
        cells = (turns * A * A + rollout.actions[0::2].long() * A
                 + rollout.actions[1::2].long())
        return Counts(int(torch.unique(turns).numel()),
                      int(torch.unique(cells).numel()),
                      int(torch.unique(learner.indices[0::2]).numel()))

    @staticmethod
    def most(step: "MLPStep") -> "Counts":
        """Every lane's turn on a state and cell of its own: the most a
        step could read, where no trajectory is drawn."""
        n = float(step.B * step.levels)
        return Counts(n, n, n)


@dataclasses.dataclass(frozen=True)
class MLPStep:
    """The shapes of one train step of the two-head MLP: A actions, T
    chance outcomes a joint cell, ``levels`` turns a rollout (the tree's
    max depth; 2 * levels half-steps), B lanes, the net's width and depth,
    the learner's, the frozen passes' and the actor's operand types, and
    for the buffered step (``buffered``) one rollout every
    ``buffer_mod``-th step.  ``store_obs``: the rollout stores the
    observations and the learner reads them, with no regather
    (``RNaDConfig.store_rollout_obs``, which ``of`` reads)."""

    A: int
    T: int
    levels: int
    B: int
    width: int = 256
    depth: int = 1
    dtype: str = "float32"
    frozen_dtype: str = "float32"
    actor_dtype: str = "float32"
    detailed_metrics: bool = True
    buffered: bool = False
    buffer_mod: int = 1
    store_obs: bool = False

    @staticmethod
    def of(cfg, net_config, A: int, T: int, levels: int) -> "MLPStep":
        """From an ``RNaDConfig`` and an MLP's ``NetConfig`` on a tree of
        (A, T, levels); raises for what the model does not cover."""
        if net_config.type != "MLP":
            raise ValueError(f"no roofline model of a {net_config.type} "
                             "(tools/roofline.py models the MLP towers "
                             "only)")
        if cfg.obs_transform.kind != "none":
            raise ValueError("no roofline model of a lifted observation")
        dtype = net_config.compute_dtype
        bf16_actor = cfg.rollout_actor_dtype == "bfloat16"
        return MLPStep(
            A=A, T=T, levels=levels, B=cfg.batch_size,
            width=net_config.width, depth=net_config.depth, dtype=dtype,
            frozen_dtype=(dtype if cfg.frozen_net_dtype == "float32"
                          else cfg.frozen_net_dtype),
            actor_dtype="bfloat16" if bf16_actor else dtype,
            detailed_metrics=cfg.detailed_metrics,
            buffered=cfg.n_batches_per_buffer > 1 or cfg.buffer_mod > 1,
            buffer_mod=cfg.buffer_mod, store_obs=cfg.store_rollout_obs)

    @property
    def din(self) -> int:
        return 2 * self.A * self.A

    @property
    def samples(self) -> int:
        """Learner samples a step: (2 levels, B) half-steps."""
        return 2 * self.levels * self.B


def _elt(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def rollout_work(step: MLPStep, rows: float, cells: float) -> Work:
    """One rollout: both seats' forward of every lane's turn, and K1's
    bytes (``fused_turn.io_bytes``, with the stored observations under
    ``store_obs``) over all ``levels`` turns as one function, with the
    hidden layers' weights of a deeper MLP once."""
    s = step
    flops = matmul_flops(mlp_forward_matmuls(2 * s.B * s.levels, s.A,
                                             s.width, s.depth))
    w = _elt(s.actor_dtype)
    hidden = 2 * (s.depth - 1) * (w * s.width * s.width + 4 * s.width)
    nbytes = fused_turn.io_bytes(s.B * s.levels, s.A, s.T, 2 * s.width,
                                 rows, cells, w, s.store_obs) + hidden
    return Work({s.actor_dtype: flops}, float(nbytes))


def collate_work(step: MLPStep) -> Work:
    """The buffered step's sample: every lane's trajectory fields (index,
    action, reward, value and A policy floats a half-step, and the stored
    observation's din under ``store_obs``) read once and written once."""
    s = step
    return Work({}, 2.0 * s.samples * (s.A + 4 + s.din * s.store_obs) * 4)


def regather_work(step: MLPStep, rows: float) -> Work:
    """The learner's observations from the packed table: each turn's state
    id read, each distinct state's two observations and masks read once,
    each half-step's observation and mask written once."""
    s = step
    return Work({}, 4.0 * (s.B * s.levels + rows * (2 * s.din + 2 * s.A)
                           + s.samples * (s.din + s.A)))


def learner_work(step: MLPStep) -> Work:
    """The learner's forward and the frozen passes over the step's samples,
    the observation and mask reads, the passes' inputs and outputs, and
    v-trace's passes."""
    s, n = step, step.samples
    policy = (s.A,)
    frozen = (mlp_forward_matmuls(n, s.A, s.width, s.depth, heads=(1,))
              + mlp_forward_matmuls(2 * n, s.A, s.width, s.depth, policy))
    passes = 4
    if s.detailed_metrics:  # the target's policy (entropy_target)
        frozen += mlp_forward_matmuls(n, s.A, s.width, s.depth, policy)
        passes += 1
    work = Work({s.dtype: matmul_flops(mlp_forward_matmuls(
        n, s.A, s.width, s.depth))}, 0.0)
    work += Work({s.frozen_dtype: matmul_flops(frozen)}, 0.0)
    nbytes = (4.0 * n * (s.din + s.A)
              + passes * n * (2 * s.din + s.A + 1) * _elt(s.dtype)
              + 24.0 * n * s.A * 4)
    return work + Work({}, nbytes)


def backward_work(step: MLPStep) -> Work:
    """The parameters' gradients: the products of
    ``mlp_backward_matmuls``, two passes' inputs and outputs, and the
    gradients written once."""
    s, n = step, step.samples
    flops = matmul_flops(mlp_backward_matmuls(n, s.A, s.width, s.depth))
    nbytes = (2.0 * n * (2 * s.din + s.A + 1) * _elt(s.dtype)
              + 4.0 * mlp_params(s.A, s.width, s.depth))
    return Work({s.dtype: flops}, nbytes)


def update_work(step: MLPStep) -> Work:
    """Clip, Adam and the EMA target: the parameters, gradients, both
    moments and the target read once (float32), and the parameters, the
    moments and the target written once."""
    return Work({}, 4.0 * 9 * mlp_params(step.A, step.width, step.depth))


def step_phases(step: MLPStep, counts: Counts) -> List[Tuple[str, Work]]:
    """The step's work by phase, in ``profile_step.py``'s order.  The
    buffered step's rollout phase is one rollout over ``buffer_mod``
    steps, as ``profile_step.py`` averages it over steps with and without
    one.  A step that stores the observations has no regather."""
    roll = rollout_work(step, counts.rollout_rows, counts.rollout_cells)
    first = ([("rollout", roll)] if not step.buffered else
             [("rollout (every buffer_mod-th step)",
               roll.scaled(1.0 / step.buffer_mod)),
              ("sample + collate", collate_work(step))])
    regather = ([] if step.store_obs else
                [("regather", regather_work(step, counts.learner_rows))])
    return first + regather + [
        ("learner + frozen passes, v-trace, loss", learner_work(step)),
        ("backward", backward_work(step)),
        ("clip + Adam + EMA", update_work(step))]


def total(phases: List[Tuple[str, Work]]) -> Work:
    out = Work({}, 0.0)
    for _, work in phases:
        out += work
    return out


def _config(name: str, batch_size: Optional[int]) -> MLPStep:
    """``profile_step.py``'s configuration ``name`` at its tree config's
    depth bound (the most turns a rollout takes)."""
    from . import profile_step

    tree_cfg, net_cfg, cfg = profile_step.CONFIGS[name]
    if batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    return MLPStep.of(cfg, net_cfg, tree_cfg.max_actions,
                      tree_cfg.max_transitions, tree_cfg.depth_bound)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", choices=["mlp", "offpol"], default="mlp")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="lanes (default: profile_step.py's 32768)")
    args = parser.parse_args(argv)
    step = _config(args.net, args.batch_size)
    phases = step_phases(step, Counts.most(step))
    print(f"{args.net}: {step}")
    print("counts from shapes on the H100 SXM's published peaks (not a "
          "measurement); every lane's row and cell charged as distinct")
    for name, work in phases + [("step", total(phases))]:
        flops = ", ".join(f"{d} {f / 1e9:.6g}" for d, f in
                          sorted(work.flops.items())) or "none"
        ops_ms, hbm_ms = 1e3 * work.ops_s(), 1e3 * work.bytes_s()
        print(f"  {name:40s} GFLOP {flops}; {work.bytes / 1e6:.6g} MB; "
              f"ops {ops_ms:.6g} ms, bytes {hbm_ms:.6g} ms: bound "
              f"{max(ops_ms, hbm_ms):.6g} ms "
              f"({'hbm' if hbm_ms >= ops_ms else 'ops'})")


if __name__ == "__main__":
    main()
