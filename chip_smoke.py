"""Chip smoke test of rnad_tpu_torch on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Fifteen phases, and any failure exits nonzero (phase 15 runs before phase
14, whose profiler window slows the process's later launches):

1. Build the four CUDA kernels from ``rnad_tpu_torch/csrc`` (one nvcc
   each, started together) and print the build time and ptxas's registers
   and spills.  Generate the EquiNet path's A = 5 tree (numpy, seed 0).
2. Hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes: K2 (packed-row lookup) bitwise, on the demo tree's
   table with 131072 ids and on a synthetic (786432, 128) table; K1 (fused
   rollout turn) at 32768 lanes with width-256 random weights and shared
   noise: episodes equal except where an action's two top Gumbel scores lie
   within 1e-5 (counted), policy and values within atol 1e-5; K3 (RM+, 128
   iterations) on 65536 observed games of the A = 5 tree, the 327680 games
   of one EquiNet learner regather and 65537 random games with random
   illegal actions, under ``solver_device.agreement`` (x, y, v within atol
   1e-5 except on a counted share of diverged games, which are as good as
   the plain version's as a set: mean and worst exploitability).  Times
   each kernel (K3 at both the learner's 327680 games and one rollout
   turn's 65536), its plain version and, for K2, ``torch.index_select``,
   and prints each kernel's share of its bound.  K4 (the EquiNet's no-grad
   forwards) against the nets' own forwards at the flagship learner's
   shape (three bf16 EquiNets, A = 5, 64 channels, depth 2, primed, over
   393,216 observations) and at a flagship rollout turn's (one net over
   65,536; ``equinet_probe.probe``): every output bitwise, two launches
   equal; each timed against K4's bound.  K5 (the trainable net's
   backward) once at the flagship learner's shape, one net over 393,216
   observations with random nonzero gradients of its logits and values
   (``equinet_probe.train_probe``): every leaf's gradient within
   ``K5_LEAF_GAP`` of eager autograd's (relative to the leaf's largest),
   the forward bitwise, two launches equal; the pass timed against the
   eager pass and K5 against its bound.
3. Drive the MLP path: the demo tree (eta_sweep's config, seed 0) and 30
   fused R-NaD train steps at 32768 lanes with a width-256 MLP through
   ``RNaD.run`` and ``final_eval``, with the kernels' launch counters set to
   0 just before and read just after (4 K1 launches per step and no K2:
   K1 stores the observations the learner reads).  Checks finite losses
   and NashConv, returns in [-1, 1] and the stored solution's NashConv of
   0; times rollout half-steps/s and train
   updates/s; then holds one train step on the card against the same step
   on the CPU (plain versions) at 256 lanes.
4. Drive the EquiNet path: the solver-primed EquiNet (64 channels, depth 2,
   128 RM+ iterations, float32) for 20 steps at 32768 lanes on the A = 5
   tree (65440 nodes), counters zeroed just before and read just after:
   per step max_depth + 1 launches of K3, max_depth of K2 (one a turn; the
   learner reads the stored observations) and none of K1, and
   one K3 launch per chunk of each chunked NashConv eval, and no K4 or K5
   launch (the float32 EquiNet's rollout, learner, frozen passes and
   NashConv stay eager).  The same checks
   and throughput as phase 3, the peak device memory, and one step at 256
   lanes on the card against the CPU.
5. Drive the flagship path through the train CLI, ``rnad_tpu_torch.train.
   main``: flagship-3 of docs/SCALE.md (``docs/runs/r4-flagship3.params.
   json``), the bfloat16 solver-primed EquiNet (64 channels, depth 2, 128
   RM+ iterations) at 32768 lanes on the native generator's 785,768-node A =
   5 depth-6 tree, cut to 20 steps and 2 evals (the cuts are printed).
   Checks the tree's size, depth and hash; per step 6 launches of K2, 7
   of K3, 8 of K4 (one a rollout turn, one for the three frozen nets, one
   for the learner's forward), 1 of K5 and none of K1, and one K3 and one
   K4 launch per eval chunk; the step-0
   NashConv of checkpoint (0, 0) within 3.1e-4 of ``rnad_tpu``'s 0.0154796;
   finite metrics, ``best.ckpt`` and ``metrics.jsonl`` written,
   ``best.json`` holding the lowest eval; a second ``main`` with the same
   name resuming at checkpoint (1, 5) and ending on the same weights,
   bitwise; one bfloat16 step at 256 lanes on the card against the CPU.
   Holds K2 against its plain version at one rollout turn's 32768 lanes and
   K3 at the learner's solve, and times them; prints updates/s, device-busy
   ms a step, peak memory, the eval's wall time and the tree's generation
   time.
6. Drive the buffered (off-policy) path through the train CLI:
   r5-offpol-32k of docs/CONVERGENCE.md (``docs/runs/r5-offpol-32k.params.
   json``), a width-256 MLP at 32768 lanes on phase 5's tree (reloaded
   from its tree store) with ``--n-batches-per-buffer 4 --buffer-mod 2``,
   cut to 20 learner steps and 2 evals (``--delta-m 10``; printed).  Checks
   a rollout exactly on the steps rnad_tpu's rule gives (0, 2, ..., 18),
   the buffer filling to 4 slots, per rollout 6 K1 launches and no K2
   launch (the slots hold the stored observations), finite metrics and
   mean |return| <= 1; holds K1 at (A = 5, W = 256, 32768 lanes) against
   its plain version and times it against its bound; times learner
   updates/s; one sampled learner step on the card against the CPU (same
   slots and lanes).
7. Drive the noisy-lift ConvNet path through the train CLI: r5-noisy-conv
   (``--demo --obs-lift 8 --obs-noise-sigma 0.15 --net ConvNet --channels
   16 --net-depth 2``, 512 lanes) cut to 200 steps and 2 evals
   (``--max-updates 2``), checkpoints every 50 steps.  Checks the demo
   tree's hash, no K1 launch and one K2 launch a rollout turn (the learner
   reads the stored lifted observations), stored observations of shape
   (T, B, 9, 3, 3) whose channel 1 is the regathered legal matrix, a resume
   at checkpoint (1, 50) ending on the straight run's weights and BatchNorm
   statistics bitwise (cuDNN deterministic), and one ConvNet step and one
   noisy-MLP step on the card against the CPU; times updates/s.
8. Drive the reference's eta sweep through ``rnad_tpu_torch.eta_sweep.
   main`` (``examples/eta_sweep.py``'s experiment: the demo tree of seed 0,
   a width-256 MLP at 512 lanes, etas 0, 0.2, 0.5 and 1), cut to 2 update
   periods of 25 steps a run (printed). Checks the tree's hash against
   rnad_tpu's, every eta > 0 run starting from the eta = 0 run's weights
   bitwise, 4 K1 launches and no K2 launch a step, finite NashConv and mean
   |return| <= 1; holds K1 at (A = 3, W = 256, 512 lanes) against its plain
   version and times it against its bound. Then one step at 256 lanes on the
   card against the CPU, for a depth-2 width-256 MLP and the primed EquiNet
   with bfloat16 frozen passes and for a bfloat16 ConvNet 16x2 with
   BatchNorm: the rollouts part only at near-ties and the weights stay
   within 2 lr (plus 1e-6 of float32 rounding), and on one shared trajectory
   the losses agree within rtol 1e-3 (1e-2 for the bfloat16 ConvNet) and the
   weights within the same 2 lr. Last, the demo tree in the "pure", "mixed"
   and "enummixed" equilibrium selections on the card's host: the hash stays
   rnad_tpu's and the stored solution scores NashConv 0.
9. Drive the distillation floor through ``rnad_tpu_torch.distill_floor.
   main`` on phase 5's stored flagship tree (docs/SCALE.md's floor runs,
   cut to 300 steps a net at a node batch of 8192; printed):
   ``EquiNet:64x2s128p``, ``MLP:512x3`` and the ``RM+:2000`` skyline.
   Checks one K3 launch a step and an eval chunk and 4 for the skyline and
   none of K1 or K2, finite floors, and the skyline within 2e-4 of
   rnad_tpu's 0.001115; holds K3 at a distillation forward's 8192 games
   (128 iterations) and at a skyline chunk's 200,000 (2000 iterations)
   against its plain version and times both.  Then the bf16 rows-actor:
   the bf16 K1 at 32768 lanes (A = 3 on the demo tree, A = 5 on the
   flagship's, width 256) against its plain version by
   ``fused_turn.check_bf16`` (outputs within ``fused_turn.bf16_band``, and
   the plain version with the row or the hidden activation left unrounded
   outside it) and timed against its bound at 989 TFLOP/s, beside the
   float32 variant on the same inputs and cuBLAS's product of the gathered
   bf16 rows by W0 alone (a yardstick for the first layer, not K1's
   library call); one step at 256 lanes on the card against the CPU;
   phase 3's config with ``rollout_actor_dtype="bfloat16"`` for 30 steps
   (4 bf16 K1 launches a step, finite losses, mean |return| <= 1), then
   the trained state's rollout with the bf16 and the float32 actor, device
   time behind a sleep.  Then one learner
   step with ``vtrace_mode="associative"`` against the scan (losses rtol
   2e-5, atol 2e-6; weights rtol 1e-4, atol 1e-6) and the oracle rollout
   of the flagship tree's stored solution at 32768 lanes (mean return
   within 3 standard errors of the root value).
10. Drive data parallelism (``rnad_tpu_torch/parallel/``): (a) phase 3's
   config through the train CLI with ``--data-parallel`` (one rank over
   NCCL), cut to 10 steps and the final eval, with K1 and K2's counters
   set to 0 just before and read just after (4 K1 and no K2 launch a
   step), then the same 10 steps without the flag: the weights must be
   bitwise equal (a SUM over one rank changes nothing), and the two steps'
   back-to-back times are printed; (b) two ranks sharing the card over
   gloo through ``multiprocess_check.run_cluster`` (16384 lanes each, 3
   steps) against one rank: the step-0 lanes equal (indices, actions and
   rewards bitwise, the stored policy within 1e-6), losses and the weights'
   checksum within rtol 1e-4 / atol 1e-6, the weights bitwise equal on both
   ranks, the per-step times printed; (c) the node-sharded NashConv of
   phase 5's stored flagship tree over those two ranks: an untrained
   width-256 MLP's per-node values within rtol / atol 1e-6 of
   ``nashconv_root`` on the card, the stored solution's NashConv below
   1e-4, both wall times printed; (d) r5-offpol-32k (phase 6's argv and
   cuts) with ``--data-parallel`` (one NCCL rank: the exchange of the
   buffered step runs), counters zeroed just before: the launches, the
   weights and target bitwise and the final NashConv (two sharded evals)
   equal to phase 6's plain run, then both learner steps back to back (best
   of 2 runs, in turns) and the exchange's bytes and time (CUDA events);
   (e) r5-noisy-conv cut to 100 steps with ``--data-parallel`` (one NCCL
   rank: the ConvNet's BatchNorm over the global batch) against the plain
   run: weights, target and BatchNorm statistics bitwise, 4 K2 launches a
   step, the 23 all-reduces of one step counted (8 forward and 8 backward
   for the 4 BatchNorms, 7 of the losses, metrics and gradients) and both
   steps back to back; (f) two gloo ranks sharing the card
   (``multiprocess_check.run_cluster``) for (d)'s net, tree and buffer at
   16384 lanes a rank and (e)'s at 256, 3 steps each from a fresh buffer,
   against one rank: the collated (or step-0) lanes' indices and actions
   bitwise, losses within rtol 1e-4, weights and BatchNorm statistics equal
   on both ranks; (g) flagship-3 on phase 5's stored tree cut to one update
   period of 5 steps with ``--data-parallel`` (one NCCL rank: K3 and the
   bf16 EquiNet under the group, the eval through ``nashconv_sharded``)
   against the plain run: launches equal (6 of K2, 7 of K3, 8 of K4 and
   1 of K5 a step, K3's and K4's eval chunks), weights bitwise, NashConv
   within 1e-6.
11. Drive the model axis (``parallel/tensor_parallel.py`` on
   ``runtime.grid``): (a) phase 3's config through ``RNaD`` on a 1 x 1
   grid (one NCCL rank: the nets tensor-parallel over a model axis of one,
   the rollout on the gathered actor) for one update period of 10 steps
   and the final eval, counters zeroed just before (4 K1 and no K2 launch a
   step), against the plain run: weights, target and NashConv bitwise,
   the all-reduces of a step counted on each axis, both steps back to
   back; (b) that config as model 2 on two gloo ranks sharing the card
   (``parallel/dryrun.py::spawn_specs``, 3 steps) and (c)
   ``dryrun_multichip``'s families at full width as 4 gloo ranks at data
   2 x model 2 (2 steps each): flagship-3's bf16 EquiNet 64x2 s128 on its
   tree at 1024 lanes, r5-noisy-conv's ConvNet 16x2 on its tree at 512
   and the MLP 512x3 on the flagship tree at 4096 (the cuts printed),
   each against one NCCL rank in this process on the same spec: losses
   and the gathered learner's checksum within rtol 1e-4 (1e-3 for the
   bf16 EquiNet), the learner equal on every rank, each rank's K1, K2 and
   K3 launches and every step's all-reduces as predicted
   (``MP_COLLECTIVES``), the per-step wall times printed.
12. (a) The port's half of ``tools/validate_vs_reference.py``'s curves
   (``rnad_tpu_torch/validate_curves.py`` at the tool's defaults: 8 update
   periods of 100 steps at 512 lanes on the depth-3 tree) for the
   committed seed ``CURVES_SEED``, counters zeroed just before: the tree's
   hash and the initial weights equal the committed ones
   (``docs/port_runs/curves/``), update 0's NashConv lies within 1e-5 of
   ``rnad_tpu``'s on that tree and those weights, every eval is finite, K1
   launches max_depth and K2 none a step; the curve printed beside
   ``rnad_tpu``'s committed one.  (b) ``profile_step.py``'s phase timing
   of the ``mlp`` config (phase 3's tree) and the ``offpol`` config
   (phase 5's stored tree) with each phase's bound on the H100 SXM's
   published peaks (``roofline.py``), which side binds and its share of
   the measured time, and the step's bound against its device and
   back-to-back times: every share must lie in (0, 100 %].
13. The benchmark programs: ``rnad_tpu_torch.bench.main()`` at its
   defaults (the demo tree's rollout at 32768 and 131072 lanes, K1 a
   turn; bench.py's bf16 product step at 32768 lanes, K2 a turn and no
   regather) and ``bench_suite.main`` on ``SUITE_RUNS`` (32768 lanes: the
   demo MLP with the fused-turn row, the big tree with the bf16 actor, the
   ConvNet 16x1), counters zeroed just before each and read just after:
   the launches of K1, its bf16 variant and K2 equal the code's count
   (``suite_launches``), the bench's self-checks hold, every number is
   finite and positive and every MLP row's share of its bound lies in (0,
   100 %].  Then the synchronizing calls of one product step (where in the
   port each is made), and last the bench's rollouts behind a sleep and
   under a short profiler window (the device's idle share).
14. The learner step's options (``fuse_net_passes`` "heads" and "off",
   ``flat_optimizer``): ``learner_probe.main`` on its 8 configs at 32768
   lanes, width 256, on the demo tree, 32 timed steps each (256 in the
   probe), and f32/heads under both v-trace modes, counters zeroed just
   before and read just after: each row's self-checks hold and its
   launches a step are the kernel table's (K1 4 and K2 0 in float32, K2 4
   in bfloat16).  Then one learner step with flat against the per-leaf
   step from the same state and trajectory (bitwise), the flat steps
   against f32/heads back to back in turns (two rounds of variant, heads,
   heads, variant; 30 steps a window), and last the device operations of
   one clip + Adam + EMA tail with and without flat in a profiler around
   that call alone.
15. The rollout's variants (``env/engine.py::rollout_from``'s
   ``store_obs`` and ``lane_chunks``): (a) K1's stored-observation output
   against its plain version, bitwise, with
   float32 and bf16 operands at phase 3's shape (A = 3, W = 256, 32768
   lanes) and the offpol one (A = 5, phase 5's stored tree), the launch
   with the output giving the other outputs of the launch without it
   bitwise and those held as phases 2 and 9 hold them, K1 timed with the
   output and without it beside ``fused_turn.io_bytes``'s bound of each;
   (b) chunked rollouts against the whole one on the same full-batch
   noise at the probe's 131072 lanes: the K1 route (MLP 256 on the demo
   tree) with 2 and 4 chunks bitwise, and the generic turn of phase 4's
   solver EquiNet (its weights moved off the primed zero heads) with 4
   chunks, lanes parting only at near-ties, with each one's peak device
   memory; (c) one train step with ``store_rollout_obs`` true and false,
   on phase 3's MLP config and on flagship-3's
   (``profile_step.CONFIGS["flagship"]`` on phase 5's tree), bitwise the
   same weights, target and metrics; (d) ``rollout_probe.main`` at its
   defaults (131072 lanes, 256 rollouts a variant) on
   ``base,fused,chunk2,fused_chunk4``, counters zeroed just before and
   read just after: its self-checks hold, every
   mean return lies in [-1, 1], and K1 and K2 launch as many times as the
   variants' turns and chunks say.

It runs in a temporary working directory (the CLI writes ``saved_trees/``
and ``saved_runs/`` under it).  It prints a ``{"kernels": [...]}`` line,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the rest of the repository
beside it, it exits nonzero before printing any result.  TF32 is off for
matmuls and cuDNN throughout.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

from rnad_tpu_torch.roofline import H100_SXM

HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
F32_FLOPS = H100_SXM.flops_f32  # the CUDA cores
BF16_FLOPS = H100_SXM.flops_bf16  # the tensor cores' dense rate
B_MAIN = 32768
N_REGATHER = 131072
STEPS = 30
EQUI_STEPS = 20
RM_ITERS = 128
# the flagship learner's observations: 32768 lanes x 12 half-steps
EQUI_FROZEN_N = 393216
EQUI_TURN_N = 65536  # one flagship rollout turn: two seats of 32768 lanes
# K5's leaf gradients against eager autograd's, the largest gap over the
# leaf's largest magnitude (bf16 roundings of float32 sums in another order)
K5_LEAF_GAP = 0.02
# flagship-3 (docs/runs/r4-flagship3.params.json): its tree, net and R-NaD
# flags, then the cuts, each (flag, value, flagship-3's value)
FLAGSHIP_TREE = ["--native-gen", "--max-actions", "5", "--max-transitions",
                 "2", "--tree-depth", "6", "--transition-threshold", "0.25",
                 "--stochastic-depth", "--stochastic-prob", "0.55"]
FLAGSHIP_RUN = ["--net", "EquiNet", "--channels", "64", "--net-depth", "2",
                "--solver-iters", "128", "--solver-prime", "--compute-dtype",
                "bfloat16", "--batch-size", "32768", "--eta", "0.5", "--lr",
                "5e-5", "--gamma-avg", "0.001", "--lr-schedule", "cosine",
                "--lr-final-fraction", "0.1"]
FLAGSHIP_CUTS = [("--bounds", ["2"], "10 45"),
                 ("--delta-m", ["10"], "1500 1800"),
                 ("--policy-warmup", ["5"], "1500"),
                 ("--lr-decay-steps", ["15"], "18600"),
                 ("--checkpoint-mod", ["5"], "1000 (the CLI's default)")]
FLAGSHIP_NODES, FLAGSHIP_DEPTH = 785768, 6
FLAGSHIP_HASH = -3582253928252745740
FLAGSHIP_STEPS = 20
# rnad_tpu's untrained primed EquiNet of flagship-3 on this tree
# (joint_policy_from_net + nashconv_root): its heads start at zero, so the
# policy is the solve's, and only K3's rounding parts the port from it
STEP0_NASHCONV, STEP0_ATOL = 0.0154796, 3.1e-4
# r5-offpol-32k (docs/runs/r5-offpol-32k.params.json) on flagship-3's tree,
# reloaded from phase 5's tree store, then its cuts
OFFPOL_RUN = ["--load-tree", "flagship3", "--batch-size", "32768", "--eta",
              "0.2", "--lr", "5e-4", "--gamma-avg", "0.001", "--bounds", "2",
              "--n-batches-per-buffer", "4", "--buffer-mod", "2"]
OFFPOL_CUTS = [("--delta-m", ["10"], "300")]
OFFPOL_STEPS, OFFPOL_SLOTS, OFFPOL_MOD = 20, 4, 2
# r5-noisy-conv (docs/runs/r5-noisy-conv.params.json): the demo tree of the
# CLI's defaults, the lift and the ConvNet; its cut is --max-updates 2.  The
# tree's hash is rnad_tpu's (both packages solve its levels with the same
# native simplex), the one the run's params.json holds
NOISY_RUN = ["--demo", "--obs-lift", "8", "--obs-noise-sigma", "0.15",
             "--net", "ConvNet", "--channels", "16", "--net-depth", "2"]
NOISY_NODES, NOISY_HASH, NOISY_STEPS = 1648, -3732021709909792432, 200
# the reference's eta sweep (examples/eta_sweep.py) at seed 0, cut from 64
# update periods of 100 steps to 2 of 25.  Its tree config carries a desc,
# which the content hash takes: rnad_tpu's hash of that tree is
# SWEEP_HASH, and the same game under the config without its desc (phase
# 3's) hashes to DEMO_HASH
SWEEP_ARGV = ["--seed", "0", "--bounds", "2", "--delta-m", "25", "--name",
              "sweep"]
SWEEP_CUTS = [("--bounds", "2", "64"), ("--delta-m", "25", "100")]
SWEEP_ETAS, SWEEP_STEPS = (0.0, 0.2, 0.5, 1.0), 50
SWEEP_HASH, DEMO_HASH = 7199347968155577245, 5087467122622553942
# phase 9: distillation on phase 5's stored tree through the tool, cut from
# the full-width floors (3000 and 10000 steps; docs/port_runs/
# distill_floor/full_width.py) to a few hundred steps each
DISTILL_ARGV = ["--tree", "flagship3", "--net", "EquiNet:64x2s128p", "--net",
                "MLP:512x3", "--net", "RM+:2000", "--steps", "300",
                "--node-batch", "8192"]
DISTILL_CUTS = [("--steps", "300", "3000 (EquiNet), 10000 (MLP)")]
DISTILL_STEPS, NODE_BATCH, SKYLINE_ITERS, SKYLINE_CHUNK = 300, 8192, 2000, \
    200_000
# rnad_tpu's RM+:2000 skyline of this tree on the CPU (docs/port_runs/
# distill_floor/rnad_tpu_skyline.jsonl) and how far the port's may lie
# from it (RM+ has no random init; float32 RM+ in another order parts
# on ~0.6 % of the tree's games)
SKYLINE_NASHCONV, SKYLINE_ATOL = 0.001115, 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms, the mean over ``iters`` calls
    after ``warmup`` calls.  Each call is queued behind a sleep kernel longer than
    its enqueue, and CUDA events on either side time it on the device, so
    the host's launch overhead does not show (a kernel's own time, or the
    busy time of a function of many kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        # ~2 GHz SM clock: sleep twice the enqueue time, plus a millisecond
        torch.cuda._sleep(int((2 * host_s + 1e-3) * 2e9))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def wall_ms(fn, iters: int = 10) -> float:
    """ms of one ``fn()`` from CUDA events around ``iters`` back-to-back
    calls after a warm-up.  Nothing hides the host here, so where the host
    cannot launch kernels as fast as the device runs them its stalls show
    as gaps: what a caller waits, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_lookup(lookup_lib, table, idx, label):
    got = lookup_lib.lookup(table, idx)
    torch.cuda.synchronize()
    want = lookup_lib.lookup_plain(table, idx)
    if not torch.equal(got, want):
        raise AssertionError(f"K2 lookup differs from its plain version on "
                             f"the {label} table")
    err = float((got - want).abs().max())
    log(f"K2 lookup {label}: table {tuple(table.shape)}, {idx.numel()} ids: "
        f"bitwise equal (max_abs_err {err})")
    return err


def check_fused_turn(fused_turn_lib, args, A, T):
    """K1 against its plain version; returns (max_abs_err, near_ties, the
    kernel's actions)."""
    table, w0, b0, w1, b1, idx, g_act, g_ch = args
    B = idx.shape[0]
    got = fused_turn_lib.fused_turn(*args, A=A, T=T)
    torch.cuda.synchronize()
    want = fused_turn_lib.fused_turn_plain(*args, A=A, T=T)
    _, ml, _, _ = fused_turn_lib.turn_logits_plain(table, w0, b0, w1, b1,
                                                   idx, A=A)
    top2 = (ml + g_act).topk(2, dim=1).values
    near = ((top2[:, 0] - top2[:, 1]) < 1e-5).reshape(2, B).any(0)
    new_g, pol_g, act_g, rew_g, val_g = got
    new_w, pol_w, act_w, rew_w, val_w = want
    flipped = (act_g != act_w).any(0)
    moved = (new_g != new_w) | (rew_g != rew_w)
    if (flipped & ~near).any():
        raise AssertionError(f"K1 actions differ on "
                             f"{int((flipped & ~near).sum())} lanes without "
                             "a near-tie")
    if (moved & ~flipped).any():
        raise AssertionError(f"K1 transitions differ on "
                             f"{int((moved & ~flipped).sum())} lanes whose "
                             "actions agree")
    err = max(float((pol_g - pol_w).abs().max()),
              float((val_g - val_w).abs().max()))
    if not err <= 1e-5:
        raise AssertionError(f"K1 policy/values differ by {err} > 1e-5")
    log(f"K1 fused_turn: {B} lanes: episodes equal except {int(flipped.sum())}"
        f" flipped lanes, all within the {int(near.sum())} near-ties; policy"
        f"/values max_abs_err {err:.3g} (atol 1e-5)")
    return err, int(near.sum()), act_g


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rnad_tpu_torch.config import (NetConfig, RNaDConfig, ShapingRule,
                                       TreeConfig)
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.metrics import nashconv
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import _build
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import stepping

    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    os.chdir(workdir.name)  # the run stores and the CLI's tree store
    # the EquiNet path: the repo's "big" A = 5 config cut to depth 5, and
    # flagship-2's net (docs/SCALE.md) in float32
    equi_tree_cfg = TreeConfig(max_actions=5, max_transitions=2,
                               transition_threshold=0.25, depth_bound=5,
                               depth_bound_rule=ShapingRule(-1, -2, 0.55))
    equi_net_cfg = NetConfig(type="EquiNet", max_actions=5, channels=64,
                             depth=2, solver_iters=RM_ITERS,
                             solver_prime=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | {card}")

    # -- phase 1: build, and the EquiNet path's tree ---------------------
    t0 = time.perf_counter()
    seconds = _build.build(["lookup", "fused_turn", "rmplus", "equinet"])
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for name in seconds:
        for kernel, line in _build.ptxas_lines(_build.build_log(name)):
            log(f"  ptxas {kernel}: {line}")
    t0 = time.perf_counter()
    equi_tree = tree_lib.generate_tree(equi_tree_cfg, seed=0, device=dev)
    log(f"EquiNet tree (A=5, depth_bound 5, seed 0): S={equi_tree.size} "
        f"max_depth={equi_tree.max_depth}, generated in "
        f"{time.perf_counter() - t0:.2f} s")
    if equi_tree.size != 65440 or equi_tree.max_depth != 5:
        raise AssertionError("the A = 5 tree is not the 65440-node, "
                             "depth-5 tree of seed 0")

    # -- phase 2: kernels against their plain versions --------------------
    tree_cfg = TreeConfig(max_actions=3, max_transitions=2,
                          transition_threshold=0.3, depth_bound=4,
                          depth_bound_rule=ShapingRule(
                              delta=-1, stochastic_delta=-2,
                              stochastic_prob=0.5))
    tree = tree_lib.generate_tree(tree_cfg, seed=0, device=dev)
    packed = stepping.make_packed_tables(tree)
    A, T = tree.max_actions, tree.max_transitions
    S, D = packed.rows.shape
    log(f"demo tree: S={S} max_depth={tree.max_depth} packed {S}x{D}")
    gen = torch.Generator(device=dev).manual_seed(0)

    ids = torch.randint(0, S, (N_REGATHER,), generator=gen, device=dev,
                        dtype=torch.int32)
    k2_err = check_lookup(lookup_lib, packed.rows, ids, "demo")
    big = torch.randint(0, 1 << 24, (786432, 128), generator=gen,
                        device=dev, dtype=torch.int32).float()
    big_ids = torch.randint(0, big.shape[0], (N_REGATHER,), generator=gen,
                            device=dev, dtype=torch.int32)
    k2_err = max(k2_err, check_lookup(lookup_lib, big, big_ids, "synthetic"))

    net = nets.MLP(A, 256, generator=torch.Generator().manual_seed(1)).to(dev)
    weights = [w.detach().contiguous() for w in nets.mlp_fused_weights(net)]
    idx = torch.randint(0, S, (B_MAIN,), generator=gen, device=dev,
                        dtype=torch.int32)
    g_act, g_ch = engine.turn_noise(B_MAIN, A, T, gen, dev)
    turn_args = [packed.rows, *weights, idx, g_act, g_ch]
    k1_err, near_ties, k1_actions = check_fused_turn(fused_turn_lib,
                                                     turn_args, A, T)

    k1_ms = device_ms(lambda: fused_turn_lib.fused_turn(*turn_args, A=A, T=T))
    k1_plain_ms = device_ms(
        lambda: fused_turn_lib.fused_turn_plain(*turn_args, A=A, T=T))
    regather = lambda: lookup_lib.lookup(packed.rows, ids)
    k2_ms = device_ms(regather)
    k2_plain_ms = device_ms(lambda: lookup_lib.lookup_plain(packed.rows, ids))
    k2_lib_ms = device_ms(lambda: torch.index_select(packed.rows, 0, ids))
    big_ms = device_ms(lambda: lookup_lib.lookup(big, big_ids))
    big_lib_ms = device_ms(lambda: torch.index_select(big, 0, big_ids))
    log(f"K1 fused_turn {B_MAIN} lanes: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms")
    log(f"K2 lookup demo: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms,"
        f" index_select {k2_lib_ms:.4f} ms; synthetic: kernel {big_ms:.4f} "
        f"ms, index_select {big_lib_ms:.4f} ms")
    del big, big_ids

    # bounds: the larger of bytes over HBM rate and FLOPs over f32 peak
    k1_bound, k1_by, k1_flops, k1_bytes = k1_bound_of(
        fused_turn_lib, turn_args, k1_actions, A, T)
    unique_rows = int(torch.unique(ids).numel())
    k2_bytes = 4.0 * (N_REGATHER + unique_rows * D + N_REGATHER * D)
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    log(f"bounds: K1 {k1_bound:.4f} ms ({k1_by}; {k1_flops:.4g} FLOP, "
        f"{k1_bytes:.4g} B; the kernel reaches {100 * k1_bound / k1_ms:.1f} "
        f"% of it), K2 {k2_bound:.4f} ms (bytes; {k2_bytes:.4g} B, "
        f"{unique_rows} distinct rows; {100 * k2_bound / k2_ms:.1f} %)")

    equi_cfg = RNaDConfig(batch_size=B_MAIN, eta=1.0, lr=5e-5,
                          gamma_averaging=0.001, logit_clip=2.0, bounds=(2,),
                          delta_m=(10,))
    equi_run = rnad.RNaD(equi_tree, equi_cfg, equi_net_cfg,
                         directory_name="equinet", seed=0, device="cuda")
    k3 = check_rmplus_phase(equi_run, gen)
    k4 = check_equinet_phase()

    # -- phase 3: the main path -------------------------------------------
    cfg = RNaDConfig(batch_size=B_MAIN, eta=0.2, bounds=(3,), delta_m=(10,),
                     lr=1e-3, gamma_averaging=0.01, logit_clip=2.0)
    net_cfg = NetConfig(type="MLP", max_actions=A, width=256)
    run = rnad.RNaD(tree, cfg, net_cfg, directory_name="mlp", seed=0,
                    device="cuda")
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    t0 = time.perf_counter()
    run.run(log_mod=1)
    final = run.final_eval()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = fused_turn_lib.fused_turn.launches
    k2_launches = lookup_lib.lookup.launches
    steps = run.state.total_steps
    losses = [m for _, m in run.history if "loss" in m]
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    log(f"main path: {steps} train steps + {len(evals)} NashConv evals in "
        f"{wall:.2f} s; K1 launches {k1_launches}, K2 launches {k2_launches}")
    log(f"  loss first {losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f};"
        f" NashConv " + ", ".join(f"{v:.6f}" for v in evals))
    if steps != STEPS or len(losses) != STEPS:
        raise AssertionError(f"expected {STEPS} train steps, ran {steps}")
    bad = [(k, v) for m in losses for k, v in m.items()
           if not torch.isfinite(torch.tensor(v))]
    if bad or not all(torch.isfinite(torch.tensor(evals))):
        raise AssertionError(f"non-finite metrics: {bad} {evals}")
    if len(evals) != 3 or evals[-1] != final:
        raise AssertionError(f"expected 2 boundary evals and a final one: "
                             f"{evals}")
    # the learner reads the observations K1 stored (store_rollout_obs):
    # no regather
    if k1_launches != tree.max_depth * STEPS or k2_launches != 0:
        raise AssertionError(f"kernel launches K1 {k1_launches} (want "
                             f"{tree.max_depth * STEPS}), K2 {k2_launches} "
                             f"(want 0)")

    traj = rnad.rollout(run.state, run.tree, run.packed, cfg)
    returns = engine.episode_returns(traj)
    mean_abs = float(returns.abs().mean())
    if not mean_abs <= 1.0 or traj.indices.shape != (2 * tree.max_depth,
                                                     B_MAIN):
        raise AssertionError(f"rollout: mean |return| {mean_abs}, shape "
                             f"{tuple(traj.indices.shape)}")
    oracle = float(nashconv.nashconv_pure(tree, tree.solution).nashconv())
    if not abs(oracle) < 1e-5:
        raise AssertionError(f"stored solution NashConv {oracle} != 0")
    log(f"checks: mean |episode return| {mean_abs:.4f}, stored solution "
        f"NashConv {oracle:.3g}")

    # throughput on the trained state, before any CPU work of this process;
    # the host-bound wall times spread, so each is the median of 3 runs
    init = torch.ones((B_MAIN,), dtype=torch.int32, device=dev)
    rollout = lambda: engine.rollout_from(run.tree, run.packed, run.state.net,
                                          init, generator=gen)
    step = lambda: run.train_step(run.state, 1.0)
    half_steps = 2 * tree.max_depth * B_MAIN
    rollout_runs = sorted(wall_ms(rollout) for _ in range(3))
    step_runs = sorted(wall_ms(step) for _ in range(3))
    rollout_ms, step_ms = rollout_runs[1], step_runs[1]
    rollout_dev_ms = device_ms(rollout, iters=10)
    step_dev_ms = device_ms(step, iters=10)
    runs = lambda xs: "/".join(f"{x:.4f}" for x in xs)
    log(f"throughput: rollout {half_steps / rollout_ms * 1e3:.6g} env "
        f"half-steps/s ({rollout_ms:.4f} ms per {half_steps} half-steps, runs "
        f"{runs(rollout_runs)} ms, device busy {rollout_dev_ms:.4f} ms); train"
        f" {1e3 / step_ms:.6g} updates/s ({step_ms:.4f} ms per step, runs "
        f"{runs(step_runs)} ms, device busy {step_dev_ms:.4f} ms) | {card}")
    check_against_cpu(tree, cfg, net_cfg)

    # -- phase 4: the EquiNet path ----------------------------------------
    equi = equinet_phase(equi_run, card)
    del equi_run

    # -- phase 5: the flagship path through the train CLI -----------------
    flag = flagship_phase(card, gen)

    # -- phase 6: the buffered path on the flagship's tree ----------------
    offpol = offpol_phase(card, gen)

    # -- phase 7: the noisy-lift ConvNet path -----------------------------
    noisy = noisy_phase(card)

    # -- phase 8: the reference's eta sweep, the new nets, selection -----
    sweep = sweep_phase(card, gen)

    # -- phase 9: distillation, the bf16 actor, associative v-trace ------
    s7 = slice7_phase(card, gen, tree, cfg, net_cfg)

    # -- phase 10: data parallelism and node-sharded NashConv -------------
    dp = dp_phase(card, tree, offpol)
    # phase 10's runs: (a) phase 3's config, (d) offpol, (e) noisy-conv and
    # (g) flagship-3, each as one data-parallel rank
    dp_paths = {"dp": "a", "dp_offpol": "d", "dp_noisy": "e",
                "dp_flagship": "g"}

    # -- phase 11: the model axis -----------------------------------------
    mp = mp_phase(card, tree)
    mp_paths = {"mp": "a", "mp_model2_rank0": "b", "mp_2x2_rank0": "c"}

    # -- phase 12: the curves against rnad_tpu, the MLP steps' roofline --
    t_phase = time.perf_counter()
    curves = curves_phase(card)
    roofline_phase(card, tree)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 13: the benchmark programs ---------------------------------
    bench = bench_phase(card)

    # -- phase 15: the rollout's variants (before phase 14, whose profiler
    # window slows the process's later launches) --------------------------
    rollouts = rollout_phase(card, tree, equi_tree)

    # -- phase 14: the learner step's options -----------------------------
    probe = learner_phase(card)
    k1_by_path = {"mlp": k1_launches, "equinet": equi["k1"], "flagship": 0,
                  "offpol": offpol["k1"], "noisy": 0, "sweep": sweep["k1"],
                  "slice7": s7["k1"],
                  **{p: dp[k].get("k1", 0) for p, k in dp_paths.items()},
                  **{p: mp[k]["k1"] for p, k in mp_paths.items()},
                  "curves": curves["k1"], "bench": bench["bench"]["k1"],
                  "bench_suite": bench["suite"]["k1"],
                  "learner_probe": probe["k1"],
                  "rollout_probe": rollouts["k1"]}
    k2_by_path = {"mlp": k2_launches, "equinet": equi["k2"],
                  "flagship": flag["k2"], "offpol": offpol["k2"],
                  "noisy": noisy["k2"], "sweep": sweep["k2"],
                  "slice7": s7["k2"],
                  **{p: dp[k]["k2"] for p, k in dp_paths.items()},
                  **{p: mp[k]["k2"] for p, k in mp_paths.items()},
                  "curves": curves["k2"], "bench": bench["bench"]["k2"],
                  "bench_suite": bench["suite"]["k2"],
                  "learner_probe": probe["k2"],
                  "rollout_probe": rollouts["k2"]}
    k3_by_path = {"mlp": 0, "equinet": equi["k3"], "flagship": flag["k3"],
                  "offpol": 0, "noisy": 0, "sweep": sweep["k3"],
                  "distill": s7["k3"],
                  **{p: dp[k].get("k3", 0) for p, k in dp_paths.items()},
                  **{p: mp[k]["k3"] for p, k in mp_paths.items()},
                  "curves": curves["k3"], "bench": 0, "bench_suite": 0,
                  "learner_probe": 0, "rollout_probe": 0}
    k4_by_path = {"check": k4.pop("launches"), "equinet": equi["k4"],
                  "flagship": flag["k4"], "dp_flagship": dp["g"]["k4"]}
    k5 = k4.pop("backward")
    k5_by_path = {"equinet": equi["k5"], "flagship": flag["k5"],
                  "dp_flagship": dp["g"]["k5"]}
    kernels = [
        {"name": "fused_turn", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/fused_turn.cu",
         "replaces": "rnad_tpu/ops/pallas_turn.py:79",
         "launches": sum(k1_by_path.values()),
         "launches_by_path": k1_by_path,
         "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "near_ties": near_ties,
         "store_obs": rollouts["obs"]},
        {"name": "lookup", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/lookup.cu",
         "replaces": "rnad_tpu/ops/pallas_lookup.py:45",
         "launches": sum(k2_by_path.values()),
         "launches_by_path": k2_by_path,
         "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2_lib_ms},
        {"name": "rmplus", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/rmplus.cu",
         "replaces": "rnad_tpu/ops/pallas_rmplus.py:52",
         "launches": sum(k3_by_path.values()),
         "launches_by_path": k3_by_path,
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "ms_rollout": k3["ms_rollout"],
         "bound_ms_rollout": k3["bound_ms_rollout"],
         "diverged_games": k3["diverged"], "games": k3["games"],
         "diverged_by_set": k3["diverged_by_set"]},
        {"name": "equinet_frozen", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/equinet.cu",
         "replaces": None, "launches": sum(k4_by_path.values()),
         "launches_by_path": k4_by_path, **k4},
        {"name": "equinet_backward", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/equinet.cu",
         "replaces": None, "launches": sum(k5_by_path.values()),
         "launches_by_path": k5_by_path, **k5},
        {"name": "lookup (flagship shapes)", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/lookup.cu",
         "replaces": "rnad_tpu/ops/pallas_lookup.py:45",
         "launches": flag["k2"], "launches_by_path": {"flagship": flag["k2"]},
         **flag["lookup"]},
        {"name": "rmplus (flagship shapes)", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/rmplus.cu",
         "replaces": "rnad_tpu/ops/pallas_rmplus.py:52",
         "launches": flag["k3"], "launches_by_path": {"flagship": flag["k3"]},
         **flag["rmplus"]},
        {"name": "fused_turn (offpol shapes)", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/fused_turn.cu",
         "replaces": "rnad_tpu/ops/pallas_turn.py:79",
         "launches": offpol["k1"], "launches_by_path": {
             "offpol": offpol["k1"]}, **offpol["fused_turn"]},
        {"name": "lookup (noisy shapes)", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/lookup.cu",
         "replaces": "rnad_tpu/ops/pallas_lookup.py:45",
         "launches": noisy["k2"], "launches_by_path": {"noisy": noisy["k2"]},
         **noisy["lookup"]},
        {"name": "fused_turn (eta sweep shapes)", "route": "cuda",
         "source": "rnad_tpu_torch/csrc/fused_turn.cu",
         "replaces": "rnad_tpu/ops/pallas_turn.py:79",
         "launches": sweep["k1"], "launches_by_path": {"sweep": sweep["k1"]},
         **sweep["fused_turn"]},
        *({"name": name, "route": "cuda",
           "source": "rnad_tpu_torch/csrc/fused_turn.cu",
           "replaces": "rnad_tpu/ops/pallas_turn.py:79",
           "launches": s7["k1_bf16"] + bench["suite"]["k1_bf16"],
           "launches_by_path": {"mlp_bf16_actor": s7["k1_bf16"],
                                "bench_suite": bench["suite"]["k1_bf16"]},
           **entry}
          for name, entry in s7["bf16"].items()),
        *({"name": name, "route": "cuda",
           "source": "rnad_tpu_torch/csrc/rmplus.cu",
           "replaces": "rnad_tpu/ops/pallas_rmplus.py:52",
           "launches": s7["k3"], "launches_by_path": {"distill": s7["k3"]},
           **entry}
          for name, entry in s7["rmplus"].items()),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    os.chdir("/")
    workdir.cleanup()
    return 0


def _games_of(obs):
    """Observed games (N, 2, A, A) -> (payoffs with illegal cells zeroed,
    legal rows, legal cols), batch-major, as the EquiNet's solve sees
    them."""
    legal = obs[:, 1]
    lr, lc = legal.amax(2), legal.amax(1)
    return obs[:, 0] * lr[:, :, None] * lc[:, None, :], lr, lc


def check_rmplus_phase(run, gen):
    """K3 against its plain version on the EquiNet path's games; times the
    learner's solve.  Returns the numbers of K3's entry in the kernels
    line."""
    from rnad_tpu_torch.env import engine, solver_device
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import rmplus as rmplus_lib
    from rnad_tpu_torch.ops import stepping

    tree, packed, dev = run.tree, run.packed, run.device
    A = tree.max_actions
    ids = torch.randint(1, tree.size, (B_MAIN,), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = stepping.lookup(packed, ids)
    sets = {"observed": _games_of(torch.cat(
        stepping.slice_observations(packed, rows)))}
    # the learner's observations after one rollout of the untrained net
    net = nets.build_net(run.net_config, torch.Generator().manual_seed(0))
    state = rnad.init_train_state(net.to(dev), torch.Generator(device=dev)
                                  .manual_seed(5))
    traj = rnad.rollout(state, tree, packed, run.cfg)
    obs, _ = engine.trajectory_observations(packed, traj)
    sets["learner"] = _games_of(obs.reshape(-1, 2, A, A))
    n = 65537  # random games, random illegal rows and columns, ragged
    lr = (torch.rand((n, A), generator=gen, device=dev) > 0.2).float()
    lc = (torch.rand((n, A), generator=gen, device=dev) > 0.2).float()
    lr[:, 0] = 1.0
    lc[:, 0] = 1.0
    M = (torch.rand((n, A, A), generator=gen, device=dev) * 2 - 1)
    sets["random"] = (M * lr[:, :, None] * lc[:, None, :], lr, lc)

    out = {"max_abs_err": 0.0, "diverged": 0, "games": 0,
           "diverged_by_set": {}}
    args = {}
    for name, (Mz, lr, lc) in sets.items():
        args[name] = (Mz.permute(1, 2, 0).contiguous(), lr.t().contiguous(),
                      lc.t().contiguous(), RM_ITERS)
        got = rmplus_lib.rmplus(*args[name])
        torch.cuda.synchronize()
        want = rmplus_lib.rmplus_plain(*args[name])
        res = solver_device.agreement(Mz, lr, lc, [t.t() for t in got[:2]],
                                      [t.t() for t in want[:2]], got[2],
                                      want[2])
        log(f"K3 rmplus {name}: {res.games} games, {RM_ITERS} iterations: "
            f"{res.diverged} diverged (> atol {solver_device.ATOL}), "
            f"max_abs_err {res.max_abs_err:.3g} on the rest; exploitability "
            f"mean {res.mean_expl[0]:.6g} (plain {res.mean_expl[1]:.6g}), "
            f"on the diverged {res.mean_expl_diverged[0]:.6g} (plain "
            f"{res.mean_expl_diverged[1]:.6g}), worst game "
            f"{res.max_expl[0]:.6g} (plain {res.max_expl[1]:.6g}); per game "
            f"kernel - plain in [{res.excess[0]:.3g}, {res.excess[1]:.3g}]")
        if not res.ok:
            raise AssertionError(f"K3 disagrees with its plain version on the"
                                 f" {name} games: {res}")
        out["max_abs_err"] = max(out["max_abs_err"], res.max_abs_err)
        out["diverged"] += res.diverged
        out["diverged_by_set"][name] = res.diverged
        out["games"] += res.games

    R = C = A

    def bound(B):
        """(ms, by) of the larger of operations over the f32 peak and bytes
        over the HBM rate, for B games."""
        ops = rmplus_lib.operations(R, C, RM_ITERS) * B
        nbytes = rmplus_lib.io_bytes(R, C, B)
        return (max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                "operations" if ops / F32_FLOPS > nbytes / HBM_BYTES_PER_S
                else "bytes")

    # the learner's solve, then one rollout turn's (the observed games)
    for key, name in (("", "learner"), ("_rollout", "observed")):
        B = args[name][0].shape[-1]
        out["ms" + key] = device_ms(lambda: rmplus_lib.rmplus(*args[name]))
        out["bound_ms" + key], out["bound_by" + key] = bound(B)
        log(f"K3 rmplus {name} ({B} games): kernel {out['ms' + key]:.4f} ms, "
            f"bound {out['bound_ms' + key]:.4f} ms ({out['bound_by' + key]};"
            f" {rmplus_lib.operations(R, C, RM_ITERS)} operations a game, "
            f"{rmplus_lib.io_bytes(R, C, B):.4g} B), "
            f"{100 * out['bound_ms' + key] / out['ms' + key]:.1f} % of it")
    out["plain_ms"] = device_ms(
        lambda: rmplus_lib.rmplus_plain(*args["learner"]), iters=5)
    log(f"K3 rmplus learner: plain version {out['plain_ms']:.4f} ms")
    return out


def check_equinet_phase():
    """K4 against its plain version (the nets' own forwards) at the
    flagship learner's shape, three frozen bf16 EquiNets (A = 5, 64
    channels, depth 2, primed, 128 RM+ iterations) over 393,216 random
    observations with illegal actions, and at a flagship rollout turn's,
    one net over 65,536, through ``equinet_probe.probe``.  Every output
    bitwise equal and two launches equal; times both.  Returns the numbers
    of K4's entry in the kernels line (the one net's under ``rollout``)."""
    from rnad_tpu_torch import equinet_probe
    from rnad_tpu_torch.ops import equinet as equinet_lib

    equinet_lib.equinet_frozen.launches = 0
    out = {}
    for n, nets_run in ((EQUI_FROZEN_N, 3), (EQUI_TURN_N, 1)):
        res = equinet_probe.probe(n, iters=20, nets_run=nets_run)
        log(f"K4 equinet_frozen ({n} observations x {nets_run} nets, A = 5,"
            f" C = 64, depth 2, primed): "
            + ", ".join(f"{k} differ {v['differ_share']:.3g} (max "
                        f"{v['max_ulps']:g} bf16 ulps)"
                        for k, v in res["outputs"].items())
            + f"; deterministic {res['deterministic']}; kernel "
            f"{res['k4_ms']:.4f} ms, plain {res['eager_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}; "
            f"{res['operations']:.4g} operations, {res['io_bytes']:.4g} B),"
            f" {res['k4_share_pct']:.1f} % of it")
        parted = {k: v for k, v in res["outputs"].items()
                  if v["differ_share"] or v["nonfinite"]}
        if parted or not res["deterministic"]:
            raise AssertionError(f"K4 is not the eager forwards bit for bit "
                                 f"at {n} x {nets_run}: {res}")
        out[nets_run] = {"max_abs_err": 0.0, "ms": res["k4_ms"],
                         "plain_ms": res["eager_ms"],
                         "bound_ms": res["bound_ms"],
                         "bound_by": res["bound_by"], "library_ms": None,
                         "observations": n, "nets": nets_run}
    res = equinet_probe.train_probe(EQUI_FROZEN_N, iters=5)
    worst = max(v["rel_gap"] for v in res["k5"].values())
    log(f"K5 equinet_backward ({EQUI_FROZEN_N} observations, one net, A = "
        f"5, C = 64, depth 2, primed): forward bitwise "
        f"{res['forward_bitwise']}, deterministic {res['deterministic']}, "
        f"largest leaf gap to eager {worst:.3g} ("
        + ", ".join(f"{k} {v['rel_gap']:.2g}" for k, v in res["k5"].items())
        + f"); pass on K4 + K5 {res['kernels_ms']:.3f} ms, eager "
        f"{res['eager_ms']:.3f} ms; K5 {res['k5_ms']:.3f} ms, bound "
        f"{res['k5_bound_ms']:.4f} ms ({res['k5_share_pct']:.1f} %)")
    if (not res["forward_bitwise"] or not res["deterministic"]
            or res["nonfinite"] or not worst <= K5_LEAF_GAP):
        raise AssertionError(f"K5 against eager autograd: {res}")
    backward = {"max_abs_err": worst, "ms": res["k5_ms"],
                "plain_ms": res["eager_ms"], "bound_ms": res["k5_bound_ms"],
                "bound_by": "operations", "library_ms": None,
                "observations": EQUI_FROZEN_N, "nets": 1}
    return {**out[3], "rollout": out[1], "backward": backward,
            "launches": equinet_lib.equinet_frozen.launches}


def equinet_phase(run, card):
    """The EquiNet main path (phase 4); returns its launch counts."""
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.metrics import nashconv
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import equinet as equinet_lib
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    tree, cfg, dev = run.tree, run.cfg, run.device
    md = tree.max_depth
    run.initialize()  # builds the net; launches nothing
    chunk = min(cfg.nashconv_chunk_nodes,
                nets.inference_chunk_nodes(run.state.net, tree.max_actions))
    chunks = math.ceil(tree.size / chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    equinet_lib.equinet_frozen.launches = 0
    equinet_lib.equinet_backward.launches = 0
    t0 = time.perf_counter()
    run.run(log_mod=1)
    final = run.final_eval()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches,
              "k3": rmplus_lib.rmplus.launches,
              "k4": equinet_lib.equinet_frozen.launches,
              "k5": equinet_lib.equinet_backward.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = run.state.total_steps
    losses = [m for _, m in run.history if "loss" in m]
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    log(f"EquiNet path: {steps} train steps + {len(evals)} NashConv evals "
        f"({chunks} chunks of {chunk} nodes each) in {wall:.2f} s; launches "
        f"K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']}, K4 "
        f"{counts['k4']}, K5 {counts['k5']}; peak "
        f"device memory {peak:.3f} GiB")
    log(f"  loss first {losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f};"
        f" NashConv " + ", ".join(f"{v:.6f}" for v in evals))
    if steps != EQUI_STEPS or len(losses) != EQUI_STEPS:
        raise AssertionError(f"expected {EQUI_STEPS} EquiNet steps, ran "
                             f"{steps}")
    bad = [(k, v) for m in losses for k, v in m.items()
           if not math.isfinite(v)]
    if bad or not all(math.isfinite(v) for v in evals):
        raise AssertionError(f"non-finite EquiNet metrics: {bad} {evals}")
    if len(evals) != 2 or evals[-1] != final:
        raise AssertionError(f"expected a boundary eval and a final one: "
                             f"{evals}")
    # K2 a turn; the learner solves the stored observations (K3) without
    # a regather; the float32 EquiNet's passes stay eager (no K4, no K5)
    want = {"k1": 0, "k2": EQUI_STEPS * md,
            "k3": EQUI_STEPS * (md + 1) + len(evals) * chunks, "k4": 0,
            "k5": 0}
    if counts != want:
        raise AssertionError(f"EquiNet path launches {counts}, want {want}")

    B = cfg.batch_size
    init = torch.ones((B,), dtype=torch.int32, device=dev)
    rollout = lambda: engine.rollout_from(run.tree, run.packed, run.state.net,
                                          init, generator=run.state.generator)
    traj = rollout()
    mean_abs = float(engine.episode_returns(traj).abs().mean())
    if not mean_abs <= 1.0 or traj.indices.shape != (2 * md, B):
        raise AssertionError(f"EquiNet rollout: mean |return| {mean_abs}, "
                             f"shape {tuple(traj.indices.shape)}")
    oracle = float(nashconv.nashconv_pure(tree, tree.solution).nashconv())
    if not abs(oracle) < 1e-5:
        raise AssertionError(f"A = 5 tree: stored solution NashConv {oracle}")
    log(f"checks: mean |episode return| {mean_abs:.4f}, stored solution "
        f"NashConv {oracle:.3g}")

    t0 = time.perf_counter()
    run.nashconv()
    torch.cuda.synchronize()
    log(f"EquiNet NashConv eval ({chunks} chunks): "
        f"{time.perf_counter() - t0:.4f} s wall")
    step = lambda: run.train_step(run.state, 1.0)
    half_steps = 2 * md * B
    rollout_runs = sorted(wall_ms(rollout, iters=5) for _ in range(3))
    step_runs = sorted(wall_ms(step, iters=5) for _ in range(3))
    rollout_ms, step_ms = rollout_runs[1], step_runs[1]
    rollout_dev_ms = device_ms(rollout, iters=5)
    step_dev_ms = device_ms(step, iters=5)
    runs = lambda xs: "/".join(f"{x:.4f}" for x in xs)
    log(f"EquiNet throughput: rollout {half_steps / rollout_ms * 1e3:.6g} env"
        f" half-steps/s ({rollout_ms:.4f} ms per {half_steps} half-steps, "
        f"runs {runs(rollout_runs)} ms, device busy {rollout_dev_ms:.4f} ms);"
        f" train {1e3 / step_ms:.6g} updates/s ({step_ms:.4f} ms per step, "
        f"runs {runs(step_runs)} ms, device busy {step_dev_ms:.4f} ms); peak "
        f"memory {peak:.3f} GiB | {card}")
    check_step_against_cpu(tree, cfg, run.net_config)
    return counts


class _Capture(logging.Handler):
    """Keeps the messages of one logger (the CLI's own lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _flagship_argv():
    argv = FLAGSHIP_TREE + FLAGSHIP_RUN + ["--log-mod", "1", "--name",
                                          "flagship3"]
    for flag, value, _ in FLAGSHIP_CUTS:
        argv += [flag, *value]
    return argv


def flagship_phase(card, gen):
    """The flagship path (phase 5): two runs of the train CLI, the second a
    resume of the first, and the checks of the module docstring.  Returns
    the launch counts and the kernels line's entries at its shapes."""
    from rnad_tpu_torch import train
    from rnad_tpu_torch.env import engine, solver_device
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import equinet as equinet_lib
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    argv = _flagship_argv()
    log("flagship path: python -m rnad_tpu_torch.train " + " ".join(argv))
    for flag, value, full in FLAGSHIP_CUTS:
        log(f"  reduced from flagship-3: {flag} {' '.join(value)} "
            f"(flagship-3: {full})")
    capture = _Capture()
    cli_log = logging.getLogger(train.__name__)
    cli_log.addHandler(capture)
    cli_log.setLevel(logging.INFO)  # whatever the root logger's level
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    equinet_lib.equinet_frozen.launches = 0
    equinet_lib.equinet_backward.launches = 0
    t0 = time.perf_counter()
    run = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches,
              "k3": rmplus_lib.rmplus.launches,
              "k4": equinet_lib.equinet_frozen.launches,
              "k5": equinet_lib.equinet_backward.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tree, cfg, store = run.tree, run.cfg, run.store
    gen_line = next(m for m in capture.lines if m.startswith("tree generated"))
    log(f"  CLI: {gen_line}; "
        + next(m for m in capture.lines if m.startswith("tree stored"))
        + "; " + next(m for m in capture.lines if m.startswith("tree:")))
    if (tree.size, tree.max_depth, tree.hash) != (
            FLAGSHIP_NODES, FLAGSHIP_DEPTH, FLAGSHIP_HASH):
        raise AssertionError(f"flagship tree: S={tree.size} max_depth="
                             f"{tree.max_depth} hash={tree.hash}, want "
                             f"{FLAGSHIP_NODES}, {FLAGSHIP_DEPTH}, "
                             f"{FLAGSHIP_HASH}")

    md, A = tree.max_depth, tree.max_actions
    chunk = min(cfg.nashconv_chunk_nodes,
                nets.inference_chunk_nodes(run.state.net, A))
    chunks = math.ceil(tree.size / chunk)
    steps = run.state.total_steps
    losses = [m for _, m in run.history if "loss" in m]
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    log(f"flagship path: {steps} train steps + {len(evals)} NashConv evals "
        f"({chunks} chunks of {chunk} nodes) in {wall:.2f} s with the tree's "
        f"generation and store; launches K1 {counts['k1']}, K2 "
        f"{counts['k2']}, K3 {counts['k3']}, K4 {counts['k4']}, K5 "
        f"{counts['k5']}; peak device "
        f"memory {peak:.3f} "
        f"GiB ({resident:.3f} GiB resident from earlier phases)")
    log(f"  loss first {losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f};"
        f" NashConv " + ", ".join(f"{v:.6f}" for v in evals))
    if steps != FLAGSHIP_STEPS or len(losses) != FLAGSHIP_STEPS:
        raise AssertionError(f"expected {FLAGSHIP_STEPS} flagship steps, ran "
                             f"{steps}")
    bad = [(k, v) for m in losses for k, v in m.items()
           if not math.isfinite(v)]
    if bad or len(evals) != 2 or not all(math.isfinite(v) for v in evals):
        raise AssertionError(f"flagship metrics: {bad}, evals {evals}")
    # K4: the bf16 EquiNet's no-grad forward once a rollout turn and once
    # an eval chunk, the three frozen nets and the learner's forward once
    # a learner step; K5 the learner's backward once a step
    want = {"k1": 0, "k2": FLAGSHIP_STEPS * md,
            "k3": FLAGSHIP_STEPS * (md + 1) + len(evals) * chunks,
            "k4": FLAGSHIP_STEPS * (md + 2) + len(evals) * chunks,
            "k5": FLAGSHIP_STEPS}
    if counts != want:
        raise AssertionError(f"flagship launches {counts}, want {want}")
    best = store.load_best_meta()
    with open(os.path.join(store.directory, "best.json")) as f:
        mirror = json.load(f)
    lines = open(os.path.join(store.directory, "metrics.jsonl")).readlines()
    if best != mirror or best["nashconv"] != min(evals):
        raise AssertionError(f"best checkpoint {best} (best.json {mirror}),"
                             f" evals {evals}")
    if len(lines) != FLAGSHIP_STEPS + len(evals):
        raise AssertionError(f"metrics.jsonl has {len(lines)} lines")
    log(f"  run store: best.ckpt at step {best['step']} (NashConv "
        f"{best['nashconv']:.6f}), {len(lines)} lines in metrics.jsonl, "
        f"checkpoints {sorted(os.listdir(os.path.join(store.directory, '0')))}"
        f" + {sorted(os.listdir(os.path.join(store.directory, '1')))}")

    # the step-0 eval: the EMA target of checkpoint (0, 0), written by
    # initialize() before the first step
    step0 = store.load_checkpoint(0, 0, run._fresh_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = float(rnad.nashconv(tree, step0.net_target, chunk).nashconv())
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    gap = value - STEP0_NASHCONV
    log(f"  step-0 NashConv {value:.7f} against rnad_tpu's {STEP0_NASHCONV}"
        f": gap {gap:+.3g} (limit {STEP0_ATOL}); one {tree.size}-node eval "
        f"({chunks} chunks) {eval_s:.4f} s wall | {card}")
    if not abs(gap) <= STEP0_ATOL:
        raise AssertionError(f"step-0 NashConv {value} is more than "
                             f"{STEP0_ATOL} from {STEP0_NASHCONV}")
    del step0

    # the resume: checkpoint (1, 5), the last 5 steps again
    first = [p.detach().clone() for name in ("net", "net_target")
             for p in getattr(run.state, name).parameters()]
    first_eval = evals[-1]
    del run
    again = train.main(argv)
    resumed = [p.detach() for name in ("net", "net_target")
               for p in getattr(again.state, name).parameters()]
    again_steps = [s for s, m in again.history if "loss" in m]
    if again_steps != list(range(FLAGSHIP_STEPS - 4, FLAGSHIP_STEPS + 1)):
        raise AssertionError(f"the resumed run trained steps {again_steps}")
    bitwise = all(torch.equal(a, b) for a, b in zip(first, resumed))
    err = max(float((a - b).abs().max()) for a, b in zip(first, resumed))
    again_eval = again.history[-1][1]["nashconv"]
    if bitwise:
        log(f"  resume at checkpoint (1, 5): the last 5 steps again end on "
            f"the same weights, bitwise; final NashConv {again_eval:.7f} "
            f"(first run {first_eval:.7f})")
    else:
        log(f"  FALLBACK: the resumed weights are not bitwise equal (max_abs_"
            f"err {err:.3g}); held to check_step_against_cpu's 2 lr")
        if not err <= 2 * cfg.lr:
            raise AssertionError(f"resume: weights differ by {err}")
    del first, resumed

    # K2 at one rollout turn's lanes (the learner reads the stored
    # observations) and K3 at the learner's solve, on a rollout of the run
    state, packed = again.state, again.packed
    traj = rnad.rollout(state, tree, packed, cfg)
    ids = traj.indices[2 * (tree.max_depth // 2)].contiguous()
    lookup = lookup_entry(lookup_lib, packed.rows, ids, "flagship turn")
    obs, _ = engine.trajectory_observations(packed, traj)
    Mz, lr_, lc_ = _games_of(obs.reshape(-1, 2, A, A))
    args = (Mz.permute(1, 2, 0).contiguous(), lr_.t().contiguous(),
            lc_.t().contiguous(), RM_ITERS)
    got = rmplus_lib.rmplus(*args)
    torch.cuda.synchronize()
    plain = rmplus_lib.rmplus_plain(*args)
    # the policy visits few states, so the batch repeats each of its games
    # thousands of times.  A game is solved alone, so its copies diverge
    # together: the share of diverged games is taken over distinct games,
    # the exploitability means and worst game over the batch as the
    # learner reads it (over the 2,099 distinct games one game parted by
    # 0.02 moves the mean by 1e-5, agreement's whole margin)
    B3 = Mz.shape[0]
    key = torch.cat([Mz.reshape(B3, -1), lr_, lc_], 1)
    _, inverse = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), B3, device=key.device)
    first = first.scatter_reduce(0, inverse, torch.arange(
        B3, device=key.device), "amin")
    pick = lambda ts: [t.t()[first] for t in ts]
    every = solver_device.agreement(Mz, lr_, lc_, [t.t() for t in got[:2]],
                                    [t.t() for t in plain[:2]], got[2],
                                    plain[2])
    res = solver_device.agreement(Mz[first], lr_[first], lc_[first],
                                  pick(got[:2]), pick(plain[:2]),
                                  got[2][first], plain[2][first])
    log(f"K3 rmplus flagship learner: {res.games} distinct games of {B3}: "
        f"{res.diverged} diverged (on all {B3}: {every.diverged}), mean "
        f"exploitability {res.mean_expl[0]:.6g} (plain {res.mean_expl[1]:.6g}"
        f"), on all {every.mean_expl[0]:.6g} (plain {every.mean_expl[1]:.6g})"
        f", worst {res.max_expl[0]:.6g} (plain {res.max_expl[1]:.6g})")
    sd = solver_device
    ok = (res.diverged <= sd.DIVERGED_SHARE * res.games
          and every.mean_expl[0] <= every.mean_expl[1] + sd.MEAN_EXCESS
          and every.mean_expl_diverged[0]
          <= every.mean_expl_diverged[1] + sd.DIVERGED_MEAN_EXCESS
          and every.max_expl[0] <= every.max_expl[1] + sd.MAX_EXCESS)
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version on the "
                             f"flagship learner's games: {res}, {every}")
    ops = rmplus_lib.operations(A, A, RM_ITERS) * B3
    nbytes = rmplus_lib.io_bytes(A, A, B3)
    rm = {"max_abs_err": res.max_abs_err,
          "ms": device_ms(lambda: rmplus_lib.rmplus(*args)),
          "plain_ms": device_ms(lambda: rmplus_lib.rmplus_plain(*args),
                                iters=5),
          "bound_ms": max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
          "bound_by": ("operations" if ops / F32_FLOPS
                       > nbytes / HBM_BYTES_PER_S else "bytes"),
          "library_ms": None, "games": B3, "distinct_games": res.games,
          "diverged_games": res.diverged}
    log(f"K3 rmplus flagship learner ({B3} games, {RM_ITERS} iterations): "
        f"max_abs_err {res.max_abs_err:.3g} on the agreeing distinct games;"
        f" kernel {rm['ms']:.4f} ms, plain "
        f"{rm['plain_ms']:.4f} ms, bound {rm['bound_ms']:.4f} ms "
        f"({rm['bound_by']}; {ops:.4g} operations), "
        f"{100 * rm['bound_ms'] / rm['ms']:.1f} % of it")
    del traj, obs, Mz, lr_, lc_, args, got, plain

    step = lambda: again.train_step(again.state, 1.0)
    step_runs = sorted(wall_ms(step, iters=5) for _ in range(3))
    step_dev_ms = device_ms(step, iters=5)
    log(f"flagship throughput: train {1e3 / step_runs[1]:.6g} updates/s "
        f"back to back ({step_runs[1]:.4f} ms per step, runs "
        + "/".join(f"{x:.4f}" for x in step_runs) + f" ms), device busy "
        f"{step_dev_ms:.4f} ms a step ({100 * (1 - step_dev_ms / step_runs[1]):.1f}"
        f" % idle); peak memory {peak:.3f} GiB; {tree.size}-node NashConv "
        f"eval {eval_s:.4f} s wall; tree generation {gen_line} | {card}")
    check_step_against_cpu(tree.to("cpu"), cfg, again.net_config,
                              atol=2 * cfg.lr)
    cli_log.removeHandler(capture)
    return {"k2": counts["k2"], "k3": counts["k3"], "k4": counts["k4"],
            "k5": counts["k5"], "lookup": lookup, "rmplus": rm}


def k1_bound_of(fused_turn_lib, args, actions, A, T, store_obs=False):
    """(ms, by, flops, bytes) of K1's bound on ``args`` (the arguments of
    ``fused_turn``), whose lanes played ``actions`` (2, B): the larger of
    its operations over the peak rate of its weights' type (the f32 CUDA
    cores, or the tensor cores' dense bf16) and the bytes it must move over
    the HBM rate (``fused_turn.io_bytes`` on the lanes' distinct states
    and played (state, joint cell) pairs, with the stored observations'
    write under ``store_obs``)."""
    table, w0, b0, w1, b1, idx, g_act, g_ch = args
    B, H = idx.shape[0], w0.shape[1]
    rows = int(torch.unique(idx).numel())
    cells = int(torch.unique(idx.long() * A * A + actions[0].long() * A
                             + actions[1].long()).numel())
    peak = BF16_FLOPS if w0.dtype == torch.bfloat16 else F32_FLOPS
    flops = 2.0 * B * fused_turn_lib.operations(A, H)
    nbytes = float(fused_turn_lib.io_bytes(B, A, T, H, rows, cells,
                                           w0.element_size(), store_obs))
    by = "operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes"
    return (max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3, by, flops,
            nbytes)


def lookup_entry(lookup_lib, table, ids, label):
    """K2 against its plain version on ``ids`` of ``table``, timed with its
    plain version, ``torch.index_select`` and its byte bound (each id, each
    distinct row and each output row once)."""
    err = check_lookup(lookup_lib, table, ids, label)
    S, D = table.shape
    rows = int(torch.unique(ids).numel())
    nbytes = 4.0 * (ids.numel() + rows * D + ids.numel() * D)
    out = {"max_abs_err": err,
           "ms": device_ms(lambda: lookup_lib.lookup(table, ids)),
           "plain_ms": device_ms(lambda: lookup_lib.lookup_plain(table, ids)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": device_ms(lambda: torch.index_select(table, 0, ids)),
           "rows": ids.numel(), "table": [S, D], "distinct_rows": rows}
    log(f"K2 lookup {label} ({ids.numel()} ids, {rows} distinct, table "
        f"{S}x{D}): kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} "
        f"ms, index_select {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms (bytes), "
        f"{100 * out['bound_ms'] / out['ms']:.1f} % of it")
    return out


class _Recorder:
    """Notes each rollout of the buffered step and each buffer plan (the
    step count, the slots held) by wrapping ``learn/rnad.py::rollout`` and
    ``TrajectoryBuffer.plan``; ``close`` restores them."""

    def __init__(self):
        from rnad_tpu_torch.learn import buffer as buffer_lib
        from rnad_tpu_torch.learn import rnad

        self.rollouts, self.fills = [], []
        self._saved = (rnad.rollout, buffer_lib.TrajectoryBuffer.plan)
        rollout, plan = self._saved

        def record_rollout(state, *args, **kwargs):
            self.rollouts.append(state.total_steps)
            return rollout(state, *args, **kwargs)

        def record_plan(buf, *args, **kwargs):
            self.fills.append(len(buf))
            return plan(buf, *args, **kwargs)

        rnad.rollout = record_rollout
        buffer_lib.TrajectoryBuffer.plan = record_plan

    def close(self):
        from rnad_tpu_torch.learn import buffer as buffer_lib
        from rnad_tpu_torch.learn import rnad

        rnad.rollout, buffer_lib.TrajectoryBuffer.plan = self._saved


def offpol_phase(card, gen):
    """The buffered path (phase 6): r5-offpol-32k through the train CLI on
    phase 5's tree.  Returns the launch counts and the kernels line's
    entries at its shapes."""
    from rnad_tpu_torch import train
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import buffer as buffer_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    argv = OFFPOL_RUN + ["--log-mod", "1", "--name", "offpol32k"]
    for flag, value, _ in OFFPOL_CUTS:
        argv += [flag, *value]
    log("offpol path: python -m rnad_tpu_torch.train " + " ".join(argv))
    for flag, value, full in OFFPOL_CUTS:
        log(f"  reduced from r5-offpol-32k: {flag} {' '.join(value)} "
            f"(r5-offpol-32k: {full})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    recorder = _Recorder()
    t0 = time.perf_counter()
    try:
        run = train.main(argv)
        torch.cuda.synchronize()
    finally:
        recorder.close()
    wall = time.perf_counter() - t0
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches,
              "k3": rmplus_lib.rmplus.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the run's end, before the timing below moves it (phase 10 (d))
    end_weights = _weights(run)
    tree, cfg = run.tree, run.cfg
    md = tree.max_depth
    steps = run.state.total_steps
    losses = [m for _, m in run.history if "loss" in m]
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    log(f"offpol path: {steps} learner steps, {len(recorder.rollouts)} "
        f"rollouts (at steps {recorder.rollouts}), buffer held "
        f"{recorder.fills} slots, {len(evals)} NashConv evals in {wall:.2f} s"
        f" with the tree's load; launches K1 {counts['k1']}, K2 "
        f"{counts['k2']}, K3 {counts['k3']}; peak device memory {peak:.3f} "
        f"GiB")
    log(f"  loss first {losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f};"
        f" NashConv " + ", ".join(f"{v:.6f}" for v in evals))
    if (tree.size, md, tree.hash) != (FLAGSHIP_NODES, FLAGSHIP_DEPTH,
                                      FLAGSHIP_HASH):
        raise AssertionError(f"offpol tree: S={tree.size} hash={tree.hash}")
    if steps != OFFPOL_STEPS or len(losses) != OFFPOL_STEPS:
        raise AssertionError(f"expected {OFFPOL_STEPS} offpol steps, ran "
                             f"{steps}")
    # rnad_tpu's rule: a rollout when the buffer is empty or the step count
    # is a multiple of buffer_mod; at most n_batches_per_buffer slots
    want_rollouts = list(range(0, OFFPOL_STEPS, OFFPOL_MOD))
    want_fills = [min(OFFPOL_SLOTS, s // OFFPOL_MOD + 1)
                  for s in range(OFFPOL_STEPS)]
    if recorder.rollouts != want_rollouts or recorder.fills != want_fills:
        raise AssertionError(f"offpol buffer: rollouts {recorder.rollouts}, "
                             f"fills {recorder.fills}")
    bad = [(k, v) for m in losses for k, v in m.items()
           if not math.isfinite(v)]
    if bad or len(evals) != 2 or not all(math.isfinite(v) for v in evals):
        raise AssertionError(f"offpol metrics: {bad}, evals {evals}")
    # the buffer holds the stored observations: no regather
    want = {"k1": md * len(want_rollouts), "k2": 0, "k3": 0}
    if counts != want:
        raise AssertionError(f"offpol launches {counts}, want {want}")

    # K1 at the path's shape, on the run's weights and the lanes of one
    # rollout turn (the path launches no K2: the slots hold the stored
    # observations)
    state, packed = run.state, run.packed
    A, T = tree.max_actions, tree.max_transitions
    traj = rnad.rollout(state, tree, packed, cfg)
    mean_abs = float(engine.episode_returns(traj).abs().mean())
    if not mean_abs <= 1.0:
        raise AssertionError(f"offpol rollout: mean |return| {mean_abs}")
    log(f"checks: mean |episode return| {mean_abs:.4f}")
    B = cfg.batch_size
    weights = [w.detach().contiguous()
               for w in nets.mlp_fused_weights(state.net)]
    idx = traj.indices[4].contiguous()  # the third turn's lanes
    g_act, g_ch = engine.turn_noise(B, A, T, gen, traj.indices.device)
    turn_args = [packed.rows, *weights, idx, g_act, g_ch]
    k1_err, near, actions = check_fused_turn(fused_turn_lib, turn_args, A,
                                             T)
    H = weights[0].shape[1]
    rows = int(torch.unique(idx).numel())
    bound, by, flops, nbytes = k1_bound_of(fused_turn_lib, turn_args,
                                           actions, A, T)
    k1 = {"max_abs_err": k1_err,
          "ms": device_ms(lambda: fused_turn_lib.fused_turn(*turn_args, A=A,
                                                             T=T)),
          "plain_ms": device_ms(lambda: fused_turn_lib.fused_turn_plain(
              *turn_args, A=A, T=T)),
          "bound_ms": bound, "bound_by": by, "library_ms": None,
          "near_ties": near, "lanes": B, "width": H // 2, "A": A}
    log(f"K1 fused_turn offpol (A={A}, W={H // 2}, {B} lanes, {rows} distinct"
        f" rows): kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
        f"bound {bound:.4f} ms ({by}; {flops:.4g} FLOP, "
        f"{fused_turn_lib.operations(A, H)} a (lane, seat) row; {nbytes:.4g}"
        f" B), {100 * bound / k1['ms']:.1f} % of it")
    del traj, turn_args

    held = buffer_lib.TrajectoryBuffer(OFFPOL_SLOTS)
    for _ in range(OFFPOL_SLOTS):
        held.append(rnad.rollout(state, tree, packed, cfg))
    step = lambda: run.buffered_step(held, 1.0)
    step_runs = sorted(wall_ms(step, iters=10) for _ in range(3))
    step_dev_ms = device_ms(step, iters=10)
    log(f"offpol throughput: {1e3 / step_runs[1]:.6g} learner updates/s back "
        f"to back, a rollout every {cfg.buffer_mod} ({step_runs[1]:.4f} ms a "
        f"step, runs " + "/".join(f"{x:.4f}" for x in step_runs)
        + f" ms), device busy {step_dev_ms:.4f} ms a step "
        f"({100 * (1 - step_dev_ms / step_runs[1]):.1f} % idle); peak memory "
        f"{peak:.3f} GiB | {card}")
    del held
    check_buffered_against_cpu(tree.to("cpu"), cfg, run.net_config)
    return {"k1": counts["k1"], "k2": counts["k2"], "fused_turn": k1,
            "weights": end_weights, "final": evals[-1], "counts": counts}


def _weights(run):
    """Copies of the learner's and the EMA target's state dicts (weights
    and BatchNorm statistics)."""
    return {name: {k: v.detach().clone() for k, v in
                   getattr(run.state, name).state_dict().items()}
            for name in ("net", "net_target")}


def _assert_bitwise(run, weights, what):
    """``run``'s learner and target equal ``weights`` bit for bit."""
    for name, tensors in weights.items():
        for k, v in getattr(run.state, name).state_dict().items():
            if not torch.equal(v, tensors[k]):
                err = float((v.float() - tensors[k].float()).abs().max())
                raise AssertionError(f"{what}: {name}.{k} differs from the "
                                     f"plain run's ({err:.3g})")


def check_buffered_against_cpu(tree, cfg, net_cfg) -> None:
    """One sampled learner step at 256 lanes a slot on the card (kernels)
    and on the CPU (plain versions): three rollouts from the same weights
    and noise (equal episodes), the same slots and lanes, then the learner
    step on the collated batch: losses within rtol 1e-4, new weights within
    1e-4 (check_against_cpu's tolerances)."""
    import numpy as np

    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import buffer as buffer_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import stepping

    B = 256
    small = dataclasses.replace(cfg, batch_size=B)
    A, T, md = tree.max_actions, tree.max_transitions, tree.max_depth
    gen = torch.Generator().manual_seed(3)
    noise = [[engine.turn_noise(B, A, T, gen, "cpu") for _ in range(md)]
             for _ in range(3)]
    out = {}
    for device in ("cpu", "cuda"):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        buf = buffer_lib.TrajectoryBuffer(OFFPOL_SLOTS)
        for slot_noise in noise:
            buf.append(rnad.rollout(state, dtree, packed, small, slot_noise))
        slots, lanes = buf.plan(B, np.random.default_rng(7))
        metrics = rnad.learn_step(state, packed,
                                  buffer_lib.collate_slots(slots, lanes), 0.5,
                                  small)
        out[device] = (slots, metrics, [p.detach().cpu()
                                        for p in state.net.parameters()])
    (sc, mc, pc), (sg, mg, pg) = out["cpu"], out["cuda"]
    for a, b in zip(sc, sg, strict=True):
        for f in ("indices", "actions", "rewards"):
            if not torch.equal(getattr(a, f), getattr(b, f).cpu()):
                raise AssertionError(f"offpol card vs CPU: slot {f} differ")
    for k in ("loss", "loss_v", "loss_nerd"):
        a, b = float(mc[k]), float(mg[k])
        if abs(a - b) > 1e-4 * max(abs(a), 1e-6):
            raise AssertionError(f"offpol card vs CPU: {k} {b} vs {a}")
    err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    if not err <= 1e-4:
        raise AssertionError(f"offpol card vs CPU: weights differ by {err}")
    log(f"offpol card vs CPU: one sampled learner step over 3 slots of {B} "
        f"lanes agrees (episodes equal, same lanes, weights max_abs_err "
        f"{err:.3g}; loss {float(mg['loss']):.6f}, CPU "
        f"{float(mc['loss']):.6f})")


def noisy_phase(card):
    """The noisy-lift ConvNet path (phase 7): r5-noisy-conv through the
    train CLI, a resume from its run store, stored observations, and one
    ConvNet and one noisy-MLP step on the card against the CPU.  Returns the
    launch counts and K2's kernels-line entry at the path's shape."""
    from rnad_tpu_torch import train
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    argv = NOISY_RUN + ["--log-mod", "20", "--name", "noisyconv",
                        "--checkpoint-mod", "50"]
    cut = argv + ["--max-updates", "2"]
    log("noisy path: python -m rnad_tpu_torch.train " + " ".join(cut))
    log("  reduced from r5-noisy-conv: --max-updates 2 (r5-noisy-conv: 64, "
        "the --demo schedule); --checkpoint-mod 50 (1000, the CLI's "
        "default), so that a resume has a checkpoint")
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    t0 = time.perf_counter()
    run = train.main(cut)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches,
              "k3": rmplus_lib.rmplus.launches}
    tree, cfg = run.tree, run.cfg
    md, A = tree.max_depth, tree.max_actions
    steps = run.state.total_steps
    losses = [m for _, m in run.history if "loss" in m]
    evals = [m["nashconv"] for _, m in run.history if "nashconv" in m]
    log(f"noisy path: tree S={tree.size} max_depth={md} hash={tree.hash}; "
        f"{steps} train steps + {len(evals)} NashConv evals in {wall:.2f} s "
        f"with the tree's generation; launches K1 {counts['k1']}, K2 "
        f"{counts['k2']}, K3 {counts['k3']}")
    log(f"  loss first {losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f};"
        f" NashConv " + ", ".join(f"{v:.6f}" for v in evals))
    if (tree.size, tree.hash) != (NOISY_NODES, NOISY_HASH):
        raise AssertionError(f"noisy tree: S={tree.size} hash={tree.hash}, "
                             f"want {NOISY_NODES}, {NOISY_HASH}")
    if steps != NOISY_STEPS:
        raise AssertionError(f"expected {NOISY_STEPS} noisy steps, ran "
                             f"{steps}")
    bad = [(k, v) for m in losses for k, v in m.items()
           if not math.isfinite(v)]
    if bad or len(evals) != 2 or not all(math.isfinite(v) for v in evals):
        raise AssertionError(f"noisy metrics: {bad}, evals {evals}")
    want = {"k1": 0, "k2": NOISY_STEPS * md, "k3": 0}
    if counts != want:
        raise AssertionError(f"noisy launches {counts}, want {want}")
    first = {name: [t.detach().clone() for t in
                    getattr(run.state, name).state_dict().values()]
             for name in ("net", "net_target")}

    # stored observations: the lift's, with the legal matrix at channel 1
    tf = run.obs_transform
    traj = rnad.rollout(run.state, tree, run.packed, cfg, obs_transform=tf)
    B = cfg.batch_size
    C = tf.channels + 1
    raw, _ = engine.trajectory_observations(
        run.packed, dataclasses.replace(traj, obs=None))
    if (tuple(traj.obs.shape) != (2 * md, B, C, A, A)
            or not torch.equal(traj.obs[:, :, 1], raw[:, :, 1])):
        raise AssertionError(f"stored obs {tuple(traj.obs.shape)}, or its "
                             "channel 1 is not the legal matrix")
    mean_abs = float(engine.episode_returns(traj).abs().mean())
    if not mean_abs <= 1.0:
        raise AssertionError(f"noisy rollout: mean |return| {mean_abs}")
    log(f"checks: stored obs {tuple(traj.obs.shape)}, channel 1 equal to the "
        f"regathered legal matrix; mean |episode return| {mean_abs:.4f}")
    ids = traj.indices[2].contiguous()  # the second turn's lanes
    k2 = lookup_entry(lookup_lib, run.packed.rows, ids, "noisy turn")

    # the resume: checkpoint (1, 50), the last 50 steps again
    first_eval = evals[-1]
    del run, traj, raw
    again = train.main(argv + ["--max-updates", "1"])
    again_steps = [s for s, m in again.history if "loss" in m]
    if again_steps[0] != 161 or again.state.total_steps != NOISY_STEPS:
        raise AssertionError(f"the resumed run logged steps {again_steps}, "
                             f"ended at {again.state.total_steps}")
    for name, tensors in first.items():
        resumed = getattr(again.state, name).state_dict().values()
        if not all(torch.equal(a, b) for a, b in zip(tensors, resumed)):
            err = max(float((a - b).abs().max())
                      for a, b in zip(tensors, resumed))
            raise AssertionError(f"noisy resume: {name} weights or BatchNorm "
                                 f"statistics not bitwise equal ({err:.3g})")
    log(f"  resume at checkpoint (1, 50): the last 50 steps again end on the "
        f"same weights and BatchNorm statistics, bitwise; final NashConv "
        f"{again.history[-1][1]['nashconv']:.7f} (first run "
        f"{first_eval:.7f})")
    # no device_ms here: a step launches more kernels than the launch queue
    # holds, so no sleep hides the host (profile_step.py has the trace)
    step = lambda: again.train_step(again.state, 1.0)
    step_runs = sorted(wall_ms(step, iters=20) for _ in range(3))
    log(f"noisy-conv throughput: train {1e3 / step_runs[1]:.6g} updates/s "
        f"back to back ({step_runs[1]:.4f} ms per step, runs "
        + "/".join(f"{x:.4f}" for x in step_runs) + f" ms) | {card}")
    cpu_tree = tree.to("cpu")
    check_lift_against_cpu(cpu_tree, cfg, again.net_config)
    check_lift_against_cpu(cpu_tree, cfg, dataclasses.replace(
        again.net_config, type="MLP", depth=1))  # one noisy-MLP step
    return {"k2": counts["k2"], "lookup": k2}


def sweep_phase(card, gen):
    """The reference's eta sweep (phase 8): ``rnad_tpu_torch.eta_sweep.
    main`` cut to 2 update periods of 25 steps; K1 and K2 at its shapes;
    one step of each new net (a depth-2 MLP and the EquiNet with bfloat16
    frozen passes, a bfloat16 ConvNet) on the card against the CPU; the
    three equilibrium selections on the card's host.  Returns the launch
    counts and the kernels line's entries at the sweep's shapes."""
    from rnad_tpu_torch import eta_sweep
    from rnad_tpu_torch.config import NetConfig, RNaDConfig
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.metrics import nashconv
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    t_phase = time.perf_counter()
    log("sweep path: python -m rnad_tpu_torch.eta_sweep "
        + " ".join(SWEEP_ARGV))
    for flag, value, full in SWEEP_CUTS:
        log(f"  reduced from the reference's sweep: {flag} {value} "
            f"(examples/eta_sweep.py: {full})")
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    t0 = time.perf_counter()
    trials = eta_sweep.main(SWEEP_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches,
              "k3": rmplus_lib.rmplus.launches}
    tree = trials[0].tree
    md = tree.max_depth
    evals = {t.cfg.eta: [m["nashconv"] for _, m in t.history
                         if "nashconv" in m] for t in trials}
    log(f"sweep path: tree S={tree.size} max_depth={md} hash={tree.hash}; "
        f"{len(trials)} runs of {trials[0].state.total_steps} steps in "
        f"{wall:.2f} s; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 "
        f"{counts['k3']}")
    for eta, vals in evals.items():
        log(f"  eta={eta} NashConv " + ", ".join(f"{v:.6f}" for v in vals))
    bare = tree_lib.generate_tree(
        dataclasses.replace(eta_sweep.DEMO_TREE, desc=""), seed=0,
        device="cpu")
    if (tree.hash != SWEEP_HASH or bare.hash != DEMO_HASH
            or not torch.equal(bare.value, tree.value.cpu())):
        raise AssertionError(f"sweep tree: hash {tree.hash} (want "
                             f"{SWEEP_HASH}), without its desc {bare.hash} "
                             f"(want {DEMO_HASH}), or another game")
    if (tuple(t.cfg.eta for t in trials) != SWEEP_ETAS
            or any(t.state.total_steps != SWEEP_STEPS for t in trials)):
        raise AssertionError("sweep: runs or steps differ from the cut")
    if not all(len(v) == 2 and all(math.isfinite(x) for x in v)
               for v in evals.values()):
        raise AssertionError(f"sweep NashConv: {evals}")
    steps = len(trials) * SWEEP_STEPS
    want = {"k1": md * steps, "k2": 0, "k3": 0}
    if counts != want:
        raise AssertionError(f"sweep launches {counts}, want {want}")
    first = trials[0].store.load_checkpoint(0, 0, trials[0]._fresh_state())
    for t in trials[1:]:
        init = t.store.load_checkpoint(0, 0, t._fresh_state())
        if not all(torch.equal(a, b) for a, b in zip(
                init.net.state_dict().values(),
                first.net.state_dict().values())):
            raise AssertionError(f"sweep: eta={t.cfg.eta} does not start "
                                 "from eta=0.0's weights")
    last = trials[-1]
    traj = rnad.rollout(last.state, tree, last.packed, last.cfg)
    mean_abs = float(engine.episode_returns(traj).abs().mean())
    if not mean_abs <= 1.0:
        raise AssertionError(f"sweep rollout: mean |return| {mean_abs}")
    log(f"checks: tree hash {tree.hash} (rnad_tpu's; {bare.hash} without "
        f"the desc), every eta>0 run starts from eta=0.0's weights bitwise, "
        f"K1 {md} launches a step, mean |episode return| {mean_abs:.4f}")

    # K1 at the sweep's shape (B = 512, A = 3, W = 256) on the last run's
    # weights and one turn's lanes (the sweep launches no K2: the learner
    # reads the observations K1 stored)
    packed, cfg = last.packed, last.cfg
    A, T, B = tree.max_actions, tree.max_transitions, cfg.batch_size
    weights = [w.detach().contiguous()
               for w in nets.mlp_fused_weights(last.state.net)]
    idx = traj.indices[2].contiguous()  # the second turn's lanes
    g_act, g_ch = engine.turn_noise(B, A, T, gen, idx.device)
    turn_args = [packed.rows, *weights, idx, g_act, g_ch]
    k1_err, near, actions = check_fused_turn(fused_turn_lib, turn_args, A,
                                             T)
    H = weights[0].shape[1]
    rows = int(torch.unique(idx).numel())
    bound, by, flops, nbytes = k1_bound_of(fused_turn_lib, turn_args,
                                           actions, A, T)
    k1 = {"max_abs_err": k1_err,
          "ms": device_ms(lambda: fused_turn_lib.fused_turn(*turn_args, A=A,
                                                             T=T)),
          "plain_ms": device_ms(lambda: fused_turn_lib.fused_turn_plain(
              *turn_args, A=A, T=T)),
          "bound_ms": bound, "bound_by": by, "library_ms": None,
          "near_ties": near, "lanes": B, "width": H // 2, "A": A}
    log(f"K1 fused_turn sweep (A={A}, W={H // 2}, {B} lanes, {rows} distinct"
        f" rows): kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
        f"bound {bound:.6f} ms ({by}; {flops:.4g} FLOP, {nbytes:.4g} B), "
        f"{100 * bound / k1['ms']:.2f} % of it | {card}")
    del trials, traj, turn_args

    # one step of each new net at 256 lanes on the card against the CPU
    cpu_tree = tree.to("cpu")
    step_cfg = RNaDConfig(batch_size=256, eta=0.2, lr=5e-5,
                          gamma_averaging=0.01, logit_clip=2.0,
                          frozen_net_dtype="bfloat16")
    conv_cfg = dataclasses.replace(step_cfg, frozen_net_dtype="float32")
    for net_cfg, cfg in (
            (NetConfig(type="MLP", max_actions=A, width=256, depth=2),
             step_cfg),
            (NetConfig(type="EquiNet", max_actions=A, channels=64, depth=2,
                       solver_iters=RM_ITERS, solver_prime=True), step_cfg),
            (NetConfig(type="ConvNet", max_actions=A, channels=16, depth=2,
                       compute_dtype="bfloat16"), conv_cfg)):
        # 2 lr, plus the float32 rounding of the two updated weights
        check_step_against_cpu(cpu_tree, cfg, net_cfg,
                               atol=2 * cfg.lr + 1e-6)
        check_learner_against_cpu(
            cpu_tree, cfg, net_cfg,
            loss_rtol=1e-2 if net_cfg.compute_dtype == "bfloat16" else 1e-3)

    # equilibrium selection on this host: the hash stays, NashConv 0
    for mode in ("pure", "mixed", "enummixed"):
        t0 = time.perf_counter()
        sel = tree_lib.generate_tree(dataclasses.replace(
            eta_sweep.DEMO_TREE, desc="", equilibrium_selection=mode),
            seed=0, device="cpu")
        secs = time.perf_counter() - t0
        oracle = float(nashconv.nashconv_pure(sel, sel.solution).nashconv())
        moved = int((sel.solution != bare.solution).any(1).sum())
        if sel.hash != DEMO_HASH or not abs(oracle) < 1e-5 or not moved:
            raise AssertionError(f"selection {mode}: hash {sel.hash}, stored"
                                 f" solution NashConv {oracle}, {moved} "
                                 "nodes re-selected")
        log(f"selection {mode}: hash {sel.hash}, {moved} of {sel.size} nodes"
            f" store another equilibrium, stored solution NashConv "
            f"{oracle:.3g}, generated in {secs:.2f} s")
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return {"k1": counts["k1"], "k2": counts["k2"], "k3": counts["k3"],
            "fused_turn": k1}


def slice7_phase(card, gen, demo_tree, mlp_cfg, mlp_net_cfg):
    """Phase 9: distillation on phase 5's stored tree through
    ``rnad_tpu_torch.distill_floor.main``, K3 at its shapes, the bf16
    rows-actor (the bf16 K1 at the MLP paths' shapes, a step on the card
    against the CPU, phase 3's config for 30 steps), the associative
    v-trace against the scan, and the oracle rollout.  Returns the launch
    counts of its runs and the kernels line's entries."""
    import copy

    from rnad_tpu_torch import distill_floor
    from rnad_tpu_torch.env import engine, solver_device
    from rnad_tpu_torch.learn import rnad, supervised
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib
    from rnad_tpu_torch.ops import stepping
    from rnad_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    counters = lambda: {"k1": fused_turn_lib.fused_turn.launches,
                        "k1_bf16": fused_turn_lib.fused_turn.launches_bf16,
                        "k2": lookup_lib.lookup.launches,
                        "k3": rmplus_lib.rmplus.launches}

    def zero():
        fused_turn_lib.fused_turn.launches = 0
        fused_turn_lib.fused_turn.launches_bf16 = 0
        lookup_lib.lookup.launches = 0
        rmplus_lib.rmplus.launches = 0

    # -- distillation through the tool ------------------------------------
    log("distillation path: python -m rnad_tpu_torch.distill_floor "
        + " ".join(DISTILL_ARGV))
    for flag, value, full in DISTILL_CUTS:
        log(f"  reduced from the full-width floors: {flag} {value} ({full})")
    zero()
    t0 = time.perf_counter()
    lines = distill_floor.main(DISTILL_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    tree = checkpoint.load_tree("flagship3", device="cuda")
    equi_net = nets.build_net(distill_floor.parse_net("EquiNet:64x2s128p",
                                                      tree.max_actions))
    chunks = math.ceil(tree.size / nets.inference_chunk_nodes(
        equi_net, tree.max_actions))
    want = {"k1": 0, "k1_bf16": 0, "k2": 0,
            "k3": DISTILL_STEPS + chunks
            + math.ceil(tree.size / SKYLINE_CHUNK)}
    log(f"distillation: {wall:.2f} s for {len(lines) - 1} nets; launches "
        f"{counts} (want {want})")
    for line in lines:
        log(f"  {json.dumps(line)}")
    floors = {x["net"]: x["floor_nashconv"] for x in lines[1:]}
    if lines[0]["size"] != FLAGSHIP_NODES or counts != want:
        raise AssertionError(f"distillation: tree {lines[0]}, launches "
                             f"{counts}, want {want}")
    if not all(math.isfinite(v) and v >= 0 for v in floors.values()):
        raise AssertionError(f"distillation floors: {floors}")
    sky = floors["RM+:2000"]
    if not abs(sky - SKYLINE_NASHCONV) <= SKYLINE_ATOL:
        raise AssertionError(f"RM+:2000 skyline {sky} is more than "
                             f"{SKYLINE_ATOL} from rnad_tpu's "
                             f"{SKYLINE_NASHCONV}")
    log(f"  RM+:2000 skyline {sky} against rnad_tpu's {SKYLINE_NASHCONV} "
        f"(CPU): gap {sky - SKYLINE_NASHCONV:+.6f} (limit {SKYLINE_ATOL})")

    # K3 at the distillation's shapes: one forward's minibatch and a
    # skyline chunk
    obs_all = supervised.dataset(tree)[0]
    A = tree.max_actions
    rows = torch.randint(0, obs_all.shape[0], (NODE_BATCH,), generator=gen,
                         device=obs_all.device)
    rm_entries = {}
    ev, lg = tree.expected_value[:SKYLINE_CHUNK, 0], \
        tree.legal[:SKYLINE_CHUNK, 0]
    for name, (Mz, lr_, lc_), iters, plain_iters in (
            ("rmplus (distillation forward)",
             _games_of(obs_all[rows].reshape(-1, 2, A, A)), RM_ITERS, 5),
            ("rmplus (RM+:2000 skyline chunk)",
             (ev * lg, lg.amax(2), lg.amax(1)), SKYLINE_ITERS, 1)):
        args = (Mz.permute(1, 2, 0).contiguous(), lr_.t().contiguous(),
                lc_.t().contiguous(), iters)
        got = rmplus_lib.rmplus(*args)
        torch.cuda.synchronize()
        plain = rmplus_lib.rmplus_plain(*args)
        res = solver_device.agreement(
            Mz, lr_, lc_, [t.t() for t in got[:2]],
            [t.t() for t in plain[:2]], got[2], plain[2])
        B3 = Mz.shape[0]
        ops = rmplus_lib.operations(A, A, iters) * B3
        nbytes = rmplus_lib.io_bytes(A, A, B3)
        entry = {"max_abs_err": res.max_abs_err,
                 "ms": device_ms(lambda: rmplus_lib.rmplus(*args)),
                 "plain_ms": device_ms(lambda: rmplus_lib.rmplus_plain(
                     *args), iters=plain_iters, warmup=1),
                 "bound_ms": max(ops / F32_FLOPS,
                                 nbytes / HBM_BYTES_PER_S) * 1e3,
                 "bound_by": ("operations" if ops / F32_FLOPS
                              > nbytes / HBM_BYTES_PER_S else "bytes"),
                 "library_ms": None, "games": B3, "iters": iters,
                 "diverged_games": res.diverged}
        log(f"K3 {name} ({B3} games, {iters} iterations): {res.diverged} "
            f"diverged, max_abs_err {res.max_abs_err:.3g} on the rest, mean "
            f"exploitability {res.mean_expl[0]:.6g} (plain "
            f"{res.mean_expl[1]:.6g}); kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}), {100 * entry['bound_ms'] / entry['ms']:.1f}"
            f" % of it | {card}")
        if not res.ok:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"the {name} shape: {res}")
        rm_entries[name] = entry
        del args, got, plain

    # -- the bf16 actor -----------------------------------------------------
    bf16 = {}
    for name, t in (("fused_turn bf16 (A=3)", demo_tree),
                    ("fused_turn bf16 (A=5)", tree)):
        packed = stepping.make_packed_tables(t)
        A_, T_ = t.max_actions, t.max_transitions
        net = nets.MLP(A_, 256, generator=torch.Generator().manual_seed(1))
        w0, b0, w1, b1 = [w.detach().to(t.device).contiguous()
                          for w in nets.mlp_fused_weights(net)]
        idx = torch.randint(1, t.size, (B_MAIN,), generator=gen,
                            device=t.device, dtype=torch.int32)
        g_act, g_ch = engine.turn_noise(B_MAIN, A_, T_, gen, t.device)
        args = [packed.rows, w0.bfloat16(), b0, w1.bfloat16(), b1, idx,
                g_act, g_ch]
        got = fused_turn_lib.fused_turn(*args, A=A_, T=T_)
        torch.cuda.synchronize()
        res = fused_turn_lib.check_bf16(got, args, A=A_, T=T_)
        log(f"K1 {name}: {B_MAIN} lanes: {res['flipped']} flipped lanes, "
            f"all within the {res['near_ties']} near-ties of the bf16 band "
            f"(median row band {res['row_band_median']:.3g}); policy/values"
            f" max_abs_err {res['max_abs_err']:.3g}, every output within "
            f"its band; share of outputs outside it: "
            + ", ".join(f"{k} {v:.4f}" for k, v in res["controls"].items()))
        bound, by, flops, nbytes = k1_bound_of(fused_turn_lib, args, got[2],
                                               A_, T_)
        entry = {"max_abs_err": res["max_abs_err"],
                 "ms": device_ms(lambda: fused_turn_lib.fused_turn(
                     *args, A=A_, T=T_)),
                 "plain_ms": device_ms(lambda: fused_turn_lib.fused_turn_plain(
                     *args, A=A_, T=T_)),
                 "bound_ms": bound, "bound_by": by, "library_ms": None,
                 "near_ties": res["near_ties"],
                 "controls_outside_band": res["controls"],
                 "lanes": B_MAIN, "width": 256, "A": A_}
        entry["f32_variant_ms"] = device_ms(lambda: fused_turn_lib.fused_turn(
            packed.rows, w0, b0, w1, b1, idx, g_act, g_ch, A=A_, T=T_))
        # a yardstick for the product stage alone, not K1's library call:
        # cuBLAS's product of the gathered rows (both seats, bf16) by W0
        din = 2 * A_ * A_
        rows = packed.rows[idx.long()]
        x = torch.cat([rows[:, :din], rows[:, din:2 * din]]).bfloat16()
        w0_bf16 = args[1]
        entry["first_layer_matmul_ms"] = device_ms(lambda: torch.matmul(
            x, w0_bf16))
        log(f"K1 {name}: kernel {entry['ms']:.4f} ms (the float32 variant "
            f"{entry['f32_variant_ms']:.4f} ms), plain "
            f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.6f} ms "
            f"({by}; {flops:.4g} FLOP at 989 TFLOP/s bf16, {nbytes:.4g} B), "
            f"{100 * entry['bound_ms'] / entry['ms']:.2f} % of it; cuBLAS's "
            f"first-layer product alone ({tuple(x.shape)} x "
            f"{tuple(w0_bf16.shape)} bf16) {entry['first_layer_matmul_ms']:.4f}"
            f" ms | {card}")
        bf16[name] = entry
        del args, packed, rows, x

    bf16_cfg = dataclasses.replace(mlp_cfg, rollout_actor_dtype="bfloat16")
    check_bf16_step_against_cpu(demo_tree.to("cpu"), bf16_cfg, mlp_net_cfg)
    run = rnad.RNaD(demo_tree, bf16_cfg, mlp_net_cfg,
                    directory_name="mlp_bf16_actor", seed=0, device="cuda")
    zero()
    run.run(log_mod=1)
    torch.cuda.synchronize()
    actor = counters()
    losses = [m for _, m in run.history if "loss" in m]
    traj = rnad.rollout(run.state, run.tree, run.packed, bf16_cfg)
    mean_abs = float(engine.episode_returns(traj).abs().mean())
    want = {"k1": 0, "k1_bf16": demo_tree.max_depth * STEPS, "k2": 0,
            "k3": 0}
    log(f"bf16 actor: phase 3's config, {run.state.total_steps} steps; "
        f"launches {actor} (want {want}); loss first "
        f"{losses[0]['loss']:.6f} last {losses[-1]['loss']:.6f}; mean "
        f"|episode return| {mean_abs:.4f}")
    if (len(losses) != STEPS or actor != want or not mean_abs <= 1.0
            or not all(math.isfinite(v) for m in losses
                       for v in m.values())):
        raise AssertionError(f"bf16 actor run: {len(losses)} steps, "
                             f"launches {actor}, mean |return| {mean_abs}")
    # the rollout phase, where the turn's variant shows: the trained
    # state's rollout with each actor, device time behind a sleep
    rollout_ms = {
        dtype: device_ms(lambda: rnad.rollout(
            run.state, run.tree, run.packed,
            dataclasses.replace(mlp_cfg, rollout_actor_dtype=dtype)),
            iters=10)
        for dtype in ("bfloat16", "float32")}
    log(f"bf16 actor: rollout at phase 3's config ({mlp_cfg.batch_size} "
        f"lanes, {demo_tree.max_depth} turns), device busy "
        f"{rollout_ms['bfloat16']:.4f} ms with the bf16 actor, "
        f"{rollout_ms['float32']:.4f} ms with the float32 one | {card}")

    # -- the associative v-trace against the scan -------------------------
    state = run.state
    traj = rnad.rollout(state, run.tree, run.packed, mlp_cfg)
    out = {}
    for mode in ("scan", "associative"):
        s_ = rnad.init_train_state(copy.deepcopy(state.net),
                                   torch.Generator(device="cuda"))
        m = rnad.learn_step(s_, run.packed, traj, 0.5,
                            dataclasses.replace(mlp_cfg, vtrace_mode=mode))
        out[mode] = (m, [p.detach() for p in s_.net.parameters()])
    (ms_, ps), (ma, pa) = out["scan"], out["associative"]
    loss_gap = max(abs(float(ma[k]) - float(ms_[k])) - 2e-5 * abs(
        float(ms_[k])) for k in ("loss", "loss_v", "loss_nerd"))
    w_gap = max(float(((a - b).abs() - 1e-4 * b.abs()).max())
                for a, b in zip(pa, ps))
    log(f"associative v-trace: one learner step at {mlp_cfg.batch_size} "
        f"lanes against the scan: loss {float(ma['loss']):.7f} (scan "
        f"{float(ms_['loss']):.7f}); excess over rtol: losses "
        f"{loss_gap:.3g} (atol 2e-6), weights {w_gap:.3g} (atol 1e-6)")
    if not (loss_gap <= 2e-6 and w_gap <= 1e-6):
        raise AssertionError("associative v-trace parts from the scan")

    # -- the oracle rollout on the flagship tree ---------------------------
    oracle = engine.rollout_tabular(tree, tree.solution, B_MAIN,
                                    generator=gen)
    returns = engine.episode_returns(oracle)
    se = float(returns.std()) / B_MAIN ** 0.5
    gap = float(returns.mean()) - float(tree.root_value[1, 0])
    log(f"oracle rollout: {B_MAIN} lanes under the stored solution of the "
        f"{tree.size}-node tree: mean return {float(returns.mean()):.6f}, "
        f"root value {float(tree.root_value[1, 0]):.6f}, gap {gap:+.6f} "
        f"({gap / se:+.2f} standard errors)")
    if not abs(gap) < 3 * se:
        raise AssertionError("oracle rollout misses the root value")
    secs = time.perf_counter() - t_phase
    log(f"phase 9: {secs:.1f} s")
    return {"k1": actor["k1"], "k1_bf16": actor["k1_bf16"],
            "k2": actor["k2"], "k3": counts["k3"], "bf16": bf16,
            "rmplus": rm_entries}


# phase 10: phase 3's config through the train CLI as one data-parallel
# rank (NCCL) and as the plain run, cut to one update period of 10 steps
DP_ARGV = ["--max-actions", "3", "--max-transitions", "2", "--tree-depth",
           "4", "--transition-threshold", "0.3", "--stochastic-depth",
           "--stochastic-prob", "0.5", "--seed", "0", "--width", "256",
           "--batch-size", str(B_MAIN), "--eta", "0.2", "--lr", "1e-3",
           "--gamma-avg", "0.01", "--bounds", "1", "--delta-m", "10",
           "--log-mod", "1"]
DP_STEPS, DP_GLOO_STEPS = 10, 3
# (e): r5-noisy-conv cut to one update period (the --demo schedule's 100
# steps); (g): flagship-3 on phase 5's stored tree, phase 5's cuts but one
# update period of 5 steps
DP_NOISY_STEPS = 100
DP_FLAGSHIP_CUTS = [("--bounds", ["1"]), ("--delta-m", ["5"])] + [
    (flag, value) for flag, value, _ in FLAGSHIP_CUTS
    if flag not in ("--bounds", "--delta-m")]
DP_FLAGSHIP_STEPS = 5
# the all-reduces of a data-parallel step: 7 of the losses' global counts,
# the metrics and the gradients, and 2 forward and 2 backward a BatchNorm
# of the ConvNet 16x2 (4 BatchNorms)
DP_STEP_ALL_REDUCES, DP_BN_ALL_REDUCES = 7, 16


def dp_phase(card, demo_tree, offpol):
    """Phase 10: data parallelism.  (a) The train CLI with
    ``--data-parallel`` (one rank over NCCL) against the plain run, bitwise,
    and their back-to-back step times; (b) two ranks sharing the card over
    gloo (``multiprocess_check.run_cluster``) against one rank; (c) the
    node-sharded NashConv of phase 5's stored flagship tree over those two
    ranks against ``nashconv_root`` on the card; (d) r5-offpol-32k as one
    NCCL rank against phase 6's plain run (``offpol``, its result), and
    the exchange; (e) r5-noisy-conv's ConvNet with its global BatchNorm as
    one NCCL rank against the plain run; (f) (d)'s and (e)'s configs as two
    gloo ranks sharing the card against one rank; (g) flagship-3 as one
    NCCL rank against the plain run.  Returns the launch counts of (a),
    (d), (e) and (g), each the run's as one data-parallel rank."""
    from rnad_tpu_torch import multiprocess_check as mpc
    from rnad_tpu_torch import train
    from rnad_tpu_torch.config import NetConfig, RNaDConfig
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.metrics import nashconv
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.parallel import runtime
    from rnad_tpu_torch.utils import checkpoint

    import numpy as np

    t_phase = time.perf_counter()
    # -- (a) one rank over NCCL through the CLI, and the plain run --------
    log("data-parallel path: python -m rnad_tpu_torch.train --data-parallel "
        + " ".join(DP_ARGV) + " (phase 3's config, one update period of "
        f"{DP_STEPS} steps and the final eval)")
    fused_turn_lib.fused_turn.launches = 0
    lookup_lib.lookup.launches = 0
    dp_run = train.main(DP_ARGV + ["--data-parallel", "--name", "dp10"])
    torch.cuda.synchronize()
    counts = {"k1": fused_turn_lib.fused_turn.launches,
              "k2": lookup_lib.lookup.launches}
    plain_run = train.main(DP_ARGV + ["--name", "plain10"])
    steps = dp_run.state.total_steps
    if (steps != DP_STEPS or plain_run.state.total_steps != DP_STEPS
            or dp_run.group.world != 1):
        raise AssertionError(f"data-parallel CLI: {steps} steps on "
                             f"{dp_run.group.world} ranks")
    want = {"k1": demo_tree.max_depth * DP_STEPS, "k2": 0}
    if counts != want:
        raise AssertionError(f"data-parallel launches {counts}, want {want}")
    for (name, a), b in zip(dp_run.state.net.state_dict().items(),
                            plain_run.state.net.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"data-parallel run parts from the plain "
                                 f"run at {name}")
    evals = [m["nashconv"] for r in (dp_run, plain_run)
             for _, m in r.history if "nashconv" in m]
    if len(evals) != 2 or evals[0] != evals[1] or not math.isfinite(
            evals[0]):
        raise AssertionError(f"data-parallel evals {evals}")
    log(f"data-parallel CLI (one rank, NCCL): {steps} steps, launches "
        f"{counts}; weights bitwise equal to the plain run; final NashConv "
        f"{evals[0]:.6f} in both")
    group = runtime.data_group("cuda")
    try:
        cfg = RNaDConfig(batch_size=B_MAIN, eta=0.2, bounds=(3,),
                         delta_m=(10,), lr=1e-3, gamma_averaging=0.01,
                         logit_clip=2.0)
        net_cfg = NetConfig(type="MLP", max_actions=3, width=256)
        runs = {name: rnad.RNaD(demo_tree, cfg, net_cfg, directory_name=name,
                                seed=0, device="cuda", group=g)
                for name, g in (("dp_time", group), ("plain_time", None))}
        times = {name: [] for name in runs}
        for name in ("dp_time", "plain_time", "plain_time", "dp_time"):
            run = runs[name]
            run.initialize()
            times[name].append(wall_ms(lambda: run.train_step(run.state,
                                                              1.0)))
        one = torch.ones((), device="cuda")
        scalar_ms = wall_ms(lambda: group.global_sum(one), iters=100)
        grads = [p.detach().clone() for p in
                 runs["dp_time"].state.net.parameters()]
        grads_ms = wall_ms(lambda: group.sum_tensors(grads), iters=100)
    finally:
        runtime.shutdown()
    dp_ms, plain_ms = (min(times["dp_time"]), min(times["plain_time"]))
    log(f"data-parallel step, back to back at {B_MAIN} lanes (best of 2 "
        f"runs of 10, in turns): one NCCL rank {dp_ms:.4f} ms (runs "
        f"{times['dp_time']}), plain {plain_ms:.4f} ms (runs "
        f"{times['plain_time']}); the step's 7 all-reduces add "
        f"{dp_ms - plain_ms:.4f} ms; back to back, one all-reduce of a "
        f"scalar takes {scalar_ms:.4f} ms and the gradients' "
        f"({sum(g.numel() for g in grads)} floats) {grads_ms:.4f} ms | "
        f"{card}")

    # -- (b) two ranks sharing the card over gloo --------------------------
    tree_dir = checkpoint.save_tree(demo_tree, "dp_demo")
    traj_dirs = {n: os.path.abspath(f"dp_traj_{n}") for n in (1, 2)}
    kw = dict(steps=DP_GLOO_STEPS, batch_size=B_MAIN, seed=0,
              backend="gloo", device="cuda", width=256, tree_dir=tree_dir,
              timeout=600)
    t0 = time.perf_counter()
    single = mpc.run_single(traj_out=traj_dirs[1], **kw)
    t1 = time.perf_counter()
    multi = mpc.run_cluster(2, traj_out=traj_dirs[2], **kw)
    t2 = time.perf_counter()
    whole = np.load(os.path.join(traj_dirs[1], "rank0.npz"))
    lanes = B_MAIN // 2
    policy_err = 0.0
    for r in range(2):
        part = np.load(os.path.join(traj_dirs[2], f"rank{r}.npz"))
        cut = slice(r * lanes, (r + 1) * lanes)
        for field in ("indices", "actions", "rewards"):
            if not np.array_equal(part[field], whole[field][:, cut]):
                raise AssertionError(f"gloo rank {r}: {field} differ from "
                                     "the one-rank run's lanes")
        policy_err = max(policy_err, float(np.abs(
            part["policy"] - whole["policy"][:, cut]).max()))
    if not policy_err <= 1e-6:
        raise AssertionError(f"gloo ranks: stored policy off by {policy_err}")
    for a, b in zip(multi["losses"], single["losses"]):
        if not abs(a - b) <= 1e-6 + 1e-4 * abs(b):
            raise AssertionError(f"gloo losses {multi['losses']} vs one "
                                 f"rank {single['losses']}")
    if not (abs(multi["param_checksum"] - single["param_checksum"])
            <= 1e-6 + 1e-4 * abs(single["param_checksum"])):
        raise AssertionError(f"gloo checksum {multi['param_checksum']} vs "
                             f"{single['param_checksum']}")
    if len({r["param_digest"] for r in multi["ranks"]}) != 1:
        raise AssertionError("gloo ranks hold different weights")
    step_ms = lambda res: "/".join(f"{1e3 * s:.2f}" for s in res["step_s"])
    log(f"two gloo ranks on one card ({lanes} lanes each, "
        f"{DP_GLOO_STEPS} steps): step-0 lanes equal to one rank's "
        f"(indices, actions, rewards bitwise; policy max_abs_err "
        f"{policy_err:.3g}); losses {multi['losses']} vs {single['losses']}"
        f"; checksum {multi['param_checksum']:.6f} vs "
        f"{single['param_checksum']:.6f}; weights equal on both ranks")
    log(f"  per-step wall ms (host clock, synchronized; the ranks share the"
        f" card's SMs): rank 0 {step_ms(multi)}, rank 1 "
        f"{step_ms(multi['ranks'][1])}; one rank {step_ms(single)}; "
        f"cluster wall {t2 - t1:.1f} s, one rank {t1 - t0:.1f} s | {card}")

    # -- (c) node-sharded NashConv of the flagship tree --------------------
    flag_dir = os.path.abspath(os.path.join("saved_trees", "flagship3"))
    tree = checkpoint.load_tree("flagship3", device="cuda")
    if tree.size != FLAGSHIP_NODES:
        raise AssertionError(f"flagship tree has {tree.size} nodes")
    net = nets.MLP(tree.max_actions, 256,
                   generator=torch.Generator().manual_seed(3)).cuda()
    joint = nashconv.joint_policy_from_net(tree, net, 200_000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = nashconv.nashconv_root(tree, joint)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    paths = {}
    for name, policy in (("net", joint), ("solution", tree.solution)):
        paths[name] = os.path.abspath(f"dp_{name}.npy")
        np.save(paths[name], policy.cpu().numpy())
    t0 = time.perf_counter()
    got = mpc.run_nashconv(2, flag_dir, paths["net"],
                           os.path.abspath("dp_values.npz"), device="cuda",
                           backend="gloo")
    cluster_s = time.perf_counter() - t0
    values = np.load("dp_values.npz")
    err = 0.0
    for field in ("row_best", "col_best"):
        want = getattr(ref, field).cpu().numpy()
        off = np.abs(values[field] - want) - 1e-6 * np.abs(want)
        if not (off <= 1e-6).all():
            raise AssertionError(f"sharded NashConv: {field} off by "
                                 f"{float(off.max()) + 1e-6}")
        err = max(err, float(np.abs(values[field] - want).max()))
    sol = mpc.run_nashconv(2, flag_dir, paths["solution"],
                           os.path.abspath("dp_sol.npz"), device="cuda",
                           backend="gloo")
    if not abs(sol["nashconv"]) < 1e-4:
        raise AssertionError(f"sharded NashConv of the solution "
                             f"{sol['nashconv']}")
    log(f"sharded NashConv, flagship tree ({tree.size} nodes) over two gloo "
        f"ranks on the card: untrained width-256 MLP {got['nashconv']:.6f} "
        f"(nashconv_root {float(ref.nashconv()):.6f}; per node max_abs_err "
        f"{err:.3g}, rtol/atol 1e-6), solution {sol['nashconv']:.3g}")
    log(f"  wall: induction {got['seconds']:.3f} s on rank 0 (host "
        f"preparation included), {cluster_s:.1f} s with the processes' "
        f"start; nashconv_root on the card {one_s:.4f} s | {card}")
    d = dp_offpol(card, offpol)
    e, noisy_dir = dp_noisy(card)
    dp_gloo_buffered(card, flag_dir, noisy_dir)
    g = dp_flagship(card)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return {"a": counts, "d": d, "e": e, "g": g}


def _counts():
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    return {"k1": fused_turn_lib.fused_turn.launches,
            "k2": lookup_lib.lookup.launches,
            "k3": rmplus_lib.rmplus.launches}


def _zero_counts():
    from rnad_tpu_torch.ops import equinet as equinet_lib
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import lookup as lookup_lib
    from rnad_tpu_torch.ops import rmplus as rmplus_lib

    fused_turn_lib.fused_turn.launches = 0
    fused_turn_lib.fused_turn.launches_bf16 = 0
    lookup_lib.lookup.launches = 0
    rmplus_lib.rmplus.launches = 0
    equinet_lib.equinet_frozen.launches = 0
    equinet_lib.equinet_backward.launches = 0


def _in_turns(names, step, iters=10):
    """Back-to-back ms of ``step(name)`` for the two ``names``
    (data-parallel first), in turns dp, plain, plain, dp; returns each
    name's list."""
    dp, plain = names
    times = {dp: [], plain: []}
    for name in (dp, plain, plain, dp):
        times[name].append(wall_ms(lambda: step(name), iters=iters))
    return times


def dp_offpol(card, offpol):
    """Phase 10 (d): r5-offpol-32k with ``--data-parallel`` (one NCCL rank)
    through the train CLI, held against phase 6's plain run with the same
    cuts (weights bitwise, the same final NashConv), then both learner
    steps back to back and the exchange alone.  Returns the launch
    counts."""
    import numpy as np

    from rnad_tpu_torch import train
    from rnad_tpu_torch.learn import buffer as buffer_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.parallel import runtime

    argv = OFFPOL_RUN + ["--log-mod", "1", "--name", "offpol32k_dp",
                         "--data-parallel"]
    for flag, value, _ in OFFPOL_CUTS:
        argv += [flag, *value]
    log("data-parallel offpol (d): python -m rnad_tpu_torch.train "
        + " ".join(argv) + " (phase 6's run with --data-parallel)")
    _zero_counts()
    t0 = time.perf_counter()
    run = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    if run.group.world != 1 or run.state.total_steps != OFFPOL_STEPS:
        raise AssertionError(f"data-parallel offpol: {run.state.total_steps}"
                             f" steps on {run.group.world} ranks")
    if counts != offpol["counts"]:
        raise AssertionError(f"data-parallel offpol launches {counts}, the "
                             f"plain run's {offpol['counts']}")
    _assert_bitwise(run, offpol["weights"], "data-parallel offpol")
    final = [m["nashconv"] for _, m in run.history if "nashconv" in m][-1]
    if final != offpol["final"]:
        raise AssertionError(f"data-parallel offpol: final NashConv {final}"
                             f", plain {offpol['final']}")
    log(f"data-parallel offpol (one rank, NCCL): {OFFPOL_STEPS} learner "
        f"steps and 2 sharded evals in {wall:.2f} s; launches {counts} (the "
        f"plain run's); weights and target bitwise equal to phase 6's plain "
        f"run; final NashConv {final:.7f} in both")

    B = run.cfg.batch_size
    group = runtime.data_group("cuda")
    try:
        runs = {name: rnad.RNaD(run.tree, run.cfg, run.net_config,
                                directory_name=name, seed=0, device="cuda",
                                group=g)
                for name, g in (("offpol_dp_time", group),
                                ("offpol_plain_time", None))}
        held = {}
        for name, r in runs.items():
            r.initialize()
            held[name] = buffer_lib.TrajectoryBuffer(OFFPOL_SLOTS)
            for _ in range(2 * OFFPOL_SLOTS):  # fills the buffer
                r.buffered_step(held[name], 1.0)
        times = _in_turns(list(runs), lambda name: runs[name].buffered_step(
            held[name], 1.0))
        rng = np.random.default_rng(0)
        dp_buf, plain_buf = held["offpol_dp_time"], held["offpol_plain_time"]
        exchange_ms = wall_ms(lambda: dp_buf.sample(B, rng, group))
        collate_ms = wall_ms(lambda: plain_buf.sample(B, rng))
        batch = dp_buf.sample(B, rng, group)
        nbytes = sum(t.numel() * 4 for t in vars(batch).values()
                     if torch.is_tensor(t))
    finally:
        runtime.shutdown()
    dp_ms, plain_ms = (min(times["offpol_dp_time"]),
                       min(times["offpol_plain_time"]))
    log(f"data-parallel offpol learner step, back to back at {B} lanes "
        f"(best of 2 runs of 10, in turns; a rollout every "
        f"{run.cfg.buffer_mod}): one NCCL rank {dp_ms:.4f} ms (runs "
        f"{times['offpol_dp_time']}), plain {plain_ms:.4f} ms (runs "
        f"{times['offpol_plain_time']}); the exchange of {OFFPOL_SLOTS} "
        f"slots' lanes: {nbytes} bytes ({nbytes / 1e6:.2f} MB) in one int32 "
        f"and one float32 all-reduce, {exchange_ms:.4f} ms back to back "
        f"(CUDA events; plan, gather, all-reduces and slicing), against "
        f"{collate_ms:.4f} ms for the plain plan and collate | {card}")
    return counts


def dp_noisy(card):
    """Phase 10 (e): r5-noisy-conv (the lifted ConvNet 16x2 with its
    BatchNorm over the global batch) with ``--data-parallel`` (one NCCL
    rank) against the plain run, one update period each: weights and
    BatchNorm statistics bitwise equal; then both steps back to back and
    the all-reduces of one data-parallel step.  Returns the launch counts
    and the tree store's directory."""
    import torch.distributed as dist

    from rnad_tpu_torch import train
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.parallel import runtime

    argv = NOISY_RUN + ["--log-mod", "20", "--max-updates", "1"]
    log("data-parallel noisy-conv (e): python -m rnad_tpu_torch.train "
        + " ".join(argv) + " --data-parallel, and without the flag "
        f"(r5-noisy-conv cut to one update period, {DP_NOISY_STEPS} steps)")
    _zero_counts()
    t0 = time.perf_counter()
    dp = train.main(argv + ["--name", "noisyconv_dp", "--data-parallel"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    plain = train.main(argv + ["--name", "noisyconv_plain"])
    md = dp.tree.max_depth
    if (dp.state.total_steps, plain.state.total_steps) != (DP_NOISY_STEPS,
                                                           DP_NOISY_STEPS):
        raise AssertionError(f"data-parallel noisy-conv: "
                             f"{dp.state.total_steps} and "
                             f"{plain.state.total_steps} steps")
    want = {"k1": 0, "k2": DP_NOISY_STEPS * md, "k3": 0}
    if counts != want:
        raise AssertionError(f"data-parallel noisy-conv launches {counts}, "
                             f"want {want}")
    _assert_bitwise(dp, _weights(plain), "data-parallel noisy-conv")
    evals = [[m["nashconv"] for _, m in r.history if "nashconv" in m]
             for r in (dp, plain)]
    if evals[0] != evals[1] or not math.isfinite(evals[0][-1]):
        raise AssertionError(f"data-parallel noisy-conv evals {evals}")
    log(f"data-parallel noisy-conv (one rank, NCCL): {DP_NOISY_STEPS} steps "
        f"in {wall:.2f} s; launches {counts}; weights, target and BatchNorm "
        f"statistics bitwise equal to the plain run; final NashConv "
        f"{evals[0][-1]:.7f} in both")

    group = runtime.data_group("cuda")
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    try:
        runs = {name: rnad.RNaD(dp.tree, dp.cfg, dp.net_config,
                                directory_name=name, seed=0, device="cuda",
                                group=g)
                for name, g in (("noisy_dp_time", group),
                                ("noisy_plain_time", None))}
        for r in runs.values():
            r.initialize()
        dist.all_reduce = counted
        try:
            runs["noisy_dp_time"].train_step(runs["noisy_dp_time"].state,
                                             1.0)
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = all_reduce
        times = _in_turns(list(runs), lambda name: runs[name].train_step(
            runs[name].state, 1.0), iters=20)
    finally:
        runtime.shutdown()
    want = DP_STEP_ALL_REDUCES + DP_BN_ALL_REDUCES
    if calls[0] != want:
        raise AssertionError(f"a data-parallel ConvNet step issued "
                             f"{calls[0]} all-reduces, want {want}")
    dp_ms, plain_ms = (min(times["noisy_dp_time"]),
                       min(times["noisy_plain_time"]))
    log(f"data-parallel noisy-conv step, back to back at "
        f"{dp.cfg.batch_size} lanes (best of 2 runs of 20, in turns): one "
        f"NCCL rank {dp_ms:.4f} ms (runs {times['noisy_dp_time']}), plain "
        f"{plain_ms:.4f} ms (runs {times['noisy_plain_time']}); "
        f"{calls[0]} all-reduces a step ({DP_BN_ALL_REDUCES} of the 4 "
        f"BatchNorms: 8 forward, 8 backward; {DP_STEP_ALL_REDUCES} of the "
        f"losses, diagnostics and gradients) add {dp_ms - plain_ms:.4f} ms "
        f"| {card}")
    return counts, os.path.abspath(os.path.join("saved_trees",
                                                "noisyconv_dp"))


def dp_gloo_buffered(card, offpol_tree_dir, noisy_tree_dir):
    """Phase 10 (f): two gloo ranks sharing the card
    (``multiprocess_check.run_cluster``) for (d)'s config (the width-256
    MLP on phase 5's tree, 16384 lanes a rank, buffer 4, mod 2: 3 learner
    steps on a fresh buffer, the third on 2 slots, so the exchange runs)
    and (e)'s (the lifted ConvNet 16x2, 256 lanes a rank, 3 steps), each
    against one rank: the collated (or rolled-out) lanes' indices and
    actions bitwise, losses within rtol 1e-4, the weights and BatchNorm
    statistics equal on both ranks.  The worker's R-NaD hyperparameters
    (eta 0.2, lr 1e-3, gamma_avg 0.01) are the CLI's demo's."""
    import numpy as np

    from rnad_tpu_torch import multiprocess_check as mpc

    configs = {
        "offpol": dict(batch_size=B_MAIN, width=256, tree_dir=offpol_tree_dir,
                       n_batches_per_buffer=OFFPOL_SLOTS,
                       buffer_mod=OFFPOL_MOD),
        "noisy-conv": dict(batch_size=512, tree_dir=noisy_tree_dir,
                           net="ConvNet", channels=16, net_depth=2,
                           obs_lift=8, obs_noise_sigma=0.15)}
    # a rank's launches in 3 steps: offpol rolls out at steps 0 and 2 (6
    # K1 a rollout on the depth-6 tree), its learner reads the stored
    # observations;
    # the noisy ConvNet looks up once a turn (4 a step on the depth-4 tree)
    launches = {"offpol": {"k1": 12, "k2": 0, "k3": 0},
                "noisy-conv": {"k1": 0, "k2": 4 * DP_GLOO_STEPS, "k3": 0}}
    step_ms = lambda res: "/".join(f"{1e3 * s:.2f}" for s in res["step_s"])
    for name, kw in configs.items():
        dirs = {n: os.path.abspath(f"dp_{name}_{n}") for n in (1, 2)}
        common = dict(steps=DP_GLOO_STEPS, seed=0, backend="gloo",
                      device="cuda", timeout=600, **kw)
        t0 = time.perf_counter()
        single = mpc.run_single(traj_out=dirs[1], **common)
        t1 = time.perf_counter()
        multi = mpc.run_cluster(2, traj_out=dirs[2], **common)
        t2 = time.perf_counter()
        whole = np.load(os.path.join(dirs[1], "rank0.npz"))
        lanes = kw["batch_size"] // 2
        for r in range(2):
            part = np.load(os.path.join(dirs[2], f"rank{r}.npz"))
            cut = slice(r * lanes, (r + 1) * lanes)
            for field in ("indices", "actions"):
                if not np.array_equal(part[field], whole[field][..., cut]):
                    raise AssertionError(f"gloo {name} rank {r}: {field} "
                                         "differ from one rank's lanes")
        for a, b in zip(multi["losses"], single["losses"], strict=True):
            if not abs(a - b) <= 1e-6 + 1e-4 * abs(b):
                raise AssertionError(f"gloo {name} losses {multi['losses']}"
                                     f" vs one rank {single['losses']}")
        if len({r["param_digest"] for r in multi["ranks"]}) != 1:
            raise AssertionError(f"gloo {name}: the ranks hold different "
                                 "weights or BatchNorm statistics")
        for res in (single, *multi["ranks"]):
            if res["launches"] != launches[name]:
                raise AssertionError(f"gloo {name}: rank launches "
                                     f"{res['launches']}, want "
                                     f"{launches[name]}")
        which = "every step's collated" if name == "offpol" else "step-0"
        log(f"two gloo ranks on one card, {name} ({lanes} lanes each, "
            f"{DP_GLOO_STEPS} steps): {which} lanes' indices and actions "
            f"equal to one rank's; losses "
            f"{multi['losses']} vs {single['losses']}; weights and "
            f"BatchNorm statistics equal on both ranks (one SHA-256 of the "
            f"state dict); launches a rank {multi['launches']}, one rank "
            f"{single['launches']}")
        log(f"  per-step wall ms (host clock, synchronized; the ranks share "
            f"the card's SMs): rank 0 {step_ms(multi)}, rank 1 "
            f"{step_ms(multi['ranks'][1])}; one rank {step_ms(single)}; "
            f"cluster wall {t2 - t1:.1f} s, one rank {t1 - t0:.1f} s | "
            f"{card}")


def dp_flagship(card):
    """Phase 10 (g): flagship-3 with ``--data-parallel`` (one NCCL rank) on
    phase 5's stored tree, cut to one update period of 5 steps, against the
    plain run with the same cuts: K3 and the bf16 EquiNet under the group,
    the final eval through ``nashconv_sharded`` (the tree is above the
    chunk threshold).  Weights bitwise equal, NashConv within 1e-6.
    Returns the launch counts."""
    from rnad_tpu_torch import train
    from rnad_tpu_torch.ops import equinet as equinet_lib

    argv = ["--load-tree", "flagship3"] + FLAGSHIP_RUN + ["--log-mod", "1"]
    for flag, value in DP_FLAGSHIP_CUTS:
        argv += [flag, *value]
    log("data-parallel flagship (g): python -m rnad_tpu_torch.train "
        + " ".join(argv) + " --data-parallel, and without the flag "
        "(phase 5's cuts, but one update period of "
        f"{DP_FLAGSHIP_STEPS} steps)")
    runs, counts, walls = {}, {}, {}
    for name, flag in (("dp", ["--data-parallel"]), ("plain", [])):
        _zero_counts()
        t0 = time.perf_counter()
        runs[name] = train.main(argv + ["--name", f"flag_{name}"] + flag)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = {**_counts(),
                        "k4": equinet_lib.equinet_frozen.launches,
                        "k5": equinet_lib.equinet_backward.launches}
    dp, plain = runs["dp"], runs["plain"]
    if (dp.state.total_steps, plain.state.total_steps) != (
            DP_FLAGSHIP_STEPS, DP_FLAGSHIP_STEPS):
        raise AssertionError(f"data-parallel flagship: "
                             f"{dp.state.total_steps} and "
                             f"{plain.state.total_steps} steps")
    md = dp.tree.max_depth
    # K3 and K4 each once a rollout turn, once a learner step and once an
    # eval chunk, K4 once more a learner step (the learner's forward) and
    # K5 once a step (its backward, this rank's gradient)
    if (counts["dp"] != counts["plain"] or counts["dp"]["k1"] != 0
            or counts["dp"]["k2"] != DP_FLAGSHIP_STEPS * md
            or counts["dp"]["k3"] <= DP_FLAGSHIP_STEPS * (md + 1)
            or counts["dp"]["k4"] != counts["dp"]["k3"] + DP_FLAGSHIP_STEPS
            or counts["dp"]["k5"] != DP_FLAGSHIP_STEPS):
        raise AssertionError(f"data-parallel flagship launches "
                             f"{counts['dp']}, plain {counts['plain']}")
    _assert_bitwise(dp, _weights(plain), "data-parallel flagship")
    got, want = (r.history[-1][1]["nashconv"] for r in (dp, plain))
    if not abs(got - want) <= 1e-6:
        raise AssertionError(f"data-parallel flagship: NashConv {got} "
                             f"(sharded), plain {want}")
    log(f"data-parallel flagship (one rank, NCCL): {DP_FLAGSHIP_STEPS} "
        f"steps and the final eval in {walls['dp']:.2f} s (plain "
        f"{walls['plain']:.2f} s); launches {counts['dp']} (the plain "
        f"run's); weights and target bitwise equal; NashConv {got:.7f} "
        f"through nashconv_sharded, {want:.7f} through nashconv_root "
        f"(|diff| {abs(got - want):.3g}) | {card}")
    return counts["dp"]


# phase 11: the model axis.  (a) phase 3's config on a 1 x 1 grid (one NCCL
# rank) and plain, one update period of 10 steps and the final eval; (b)
# that config as model 2 on two gloo ranks sharing the card, 3 steps; (c)
# dryrun_multichip's three families at full width as 4 gloo ranks at data
# 2 x model 2, 2 steps each, their lanes cut as far as the phase's time
# forces (each cut printed)
MP_STEPS, MP_GLOO_STEPS, MP_FAMILY_STEPS = 10, 3, 2
# the all-reduces of a step on each axis: data, 7 (the losses' global
# counts, the metrics, the gradients) and 2 forward and 2 backward a
# BatchNorm; model, the actor's gather and the global norm, and the
# tensor-parallel layers' (parallel/tensor_parallel.py): the MLP's row
# layers' reduces in 6 head passes, and its even hidden layers' input
# copies in the learner's backward; the EquiNet's and the ConvNet's
# gathers in 4 forwards, and their copies in the learner's backward
MP_COLLECTIVES = {
    "a": {"model": 2, "data": 7},  # one rank: only the gather and the norm
    "b": {"model": 8, "data": 7},  # MLP 256x1: fc1's reduce a head pass
    "EquiNet": {"model": 11, "data": 7},  # 4 x 2 gathers, 1 copy
    "ConvNet": {"model": 26, "data": 23},  # 4 x 5 gathers, 4 copies
    "MLP": {"model": 16, "data": 7},  # 6 x 2 reduces, 2 copies
}
# phase 12: the committed seed of docs/port_runs/curves/ that (a) runs, and
# how far update 0's NashConv (same tree, same weights) may lie from
# rnad_tpu's on the CPU
CURVES_SEED, CURVES_ATOL = 0, 1e-5
# losses and the learner's checksum against one rank: phase 10's
# multi-rank tolerance; the bf16 EquiNet's, phase 8's bf16 card-vs-CPU rtol
MP_RTOL = {"EquiNet": 1e-3, "ConvNet": 1e-4, "MLP": 1e-4, "b": 1e-4}


def _mp_family_specs(flag_dir, noisy_dir):
    """dryrun_multichip's families at full width: flagship-3's EquiNet on
    its tree (docs/runs/r4-flagship3.params.json), r5-noisy-conv's ConvNet
    on its tree (docs/runs/r5-noisy-conv.params.json) and the distillation
    floor's MLP 512x3 on the flagship tree with phase 3's R-NaD flags;
    returns (specs, cuts, expected launches a rank)."""
    from rnad_tpu_torch.config import NetConfig, RNaDConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    params = lambda name: json.load(open(os.path.join(
        repo, "docs", "runs", f"{name}.params.json")))
    flag, noisy = params("r4-flagship3"), params("r5-noisy-conv")
    mlp_cfg = RNaDConfig(batch_size=4096, eta=0.2, bounds=(3,),
                         delta_m=(10,), lr=1e-3, gamma_averaging=0.01,
                         logit_clip=2.0)
    flag_cfg = dataclasses.replace(RNaDConfig.from_json(flag["rnad"]),
                                   batch_size=1024)
    mlp_net = NetConfig(type="MLP", max_actions=5, width=512, depth=3)
    families = [("EquiNet", flag["net"], flag_cfg.to_json(), flag_dir),
                ("ConvNet", noisy["net"], noisy["rnad"], noisy_dir),
                ("MLP", mlp_net.to_json(), mlp_cfg.to_json(), flag_dir)]
    specs = [{"name": name, "net": net, "rnad": rnad, "tree_dir": tree_dir,
              "seed": 0, "steps": MP_FAMILY_STEPS}
             for name, net, rnad, tree_dir in families]
    cuts = {"EquiNet": "--batch-size 1024 (flagship-3: 32768)",
            "ConvNet": "none (r5-noisy-conv's 512 lanes)",
            "MLP": "--batch-size 4096 (phase 3: 32768)"}
    n = MP_FAMILY_STEPS
    launches = {"EquiNet": {"k1": 0, "k2": 6 * n, "k3": 7 * n},
                "ConvNet": {"k1": 0, "k2": 4 * n, "k3": 0},
                "MLP": {"k1": 0, "k2": 6 * n, "k3": 0}}
    return specs, cuts, launches


def _check_against_one_rank(name, ranks, one, rtol, launches, collectives,
                            card):
    """The ranks' report of run ``name`` against one rank's: losses and the
    gathered learner's checksum within ``rtol`` (atol 1e-6), the learner
    equal on every rank, each rank's launches and every step's all-reduces
    as predicted; logs the per-step wall times."""
    runs = [r["runs"][name] for r in ranks]
    for a, b in zip(runs[0]["losses"] + [runs[0]["checksum"]],
                    one["losses"] + [one["checksum"]], strict=True):
        if not abs(a - b) <= 1e-6 + rtol * abs(b):
            raise AssertionError(f"model axis {name}: losses "
                                 f"{runs[0]['losses']} and checksum "
                                 f"{runs[0]['checksum']} vs one rank's "
                                 f"{one['losses']}, {one['checksum']}")
    if len({r["digest"] for r in runs}) != 1:
        raise AssertionError(f"model axis {name}: the ranks' gathered "
                             "learners differ")
    for r, run in enumerate(runs):
        if run["launches"] != launches:
            raise AssertionError(f"model axis {name}: rank {r} launches "
                                 f"{run['launches']}, want {launches}")
        if any(c != collectives for c in run["collectives"]):
            raise AssertionError(f"model axis {name}: rank {r} all-reduces "
                                 f"{run['collectives']}, want {collectives} "
                                 "a step")
    ms = lambda run: "/".join(f"{1e3 * s:.2f}" for s in run["step_s"])
    log(f"  {name}: losses {runs[0]['losses']} vs one rank "
        f"{one['losses']} (rtol {rtol:g}); learner checksum "
        f"{runs[0]['checksum']:.6f} vs {one['checksum']:.6f}, equal on every"
        f" rank; launches a rank {launches}; all-reduces a step "
        f"{collectives} of {runs[0]['bytes'][-1]} bytes a rank")
    log(f"  {name} per-step wall ms (host clock, synchronized; gloo ranks "
        f"share the card's SMs and move data through the host): "
        + ", ".join(f"rank {r} {ms(run)}" for r, run in enumerate(runs))
        + f"; one NCCL rank {ms(one)} | {card}")


def mp_phase(card, demo_tree):
    """Phase 11: the model axis.  (a) Phase 3's config through ``RNaD``
    on a 1 x 1 grid (one NCCL rank) against the plain run, bitwise, their
    back-to-back step times and the all-reduces of a step; (b) that config
    as model 2 on two gloo ranks sharing the card against one rank; (c)
    ``dryrun_multichip``'s families at full width as 4 gloo ranks at data
    2 x model 2 against one rank.  Returns the launch counts of (a) and of
    rank 0's runs in (b) and (c)."""
    import torch.distributed as dist

    from rnad_tpu_torch.config import NetConfig, RNaDConfig
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.parallel import dryrun, runtime
    from rnad_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    cfg = RNaDConfig(batch_size=B_MAIN, eta=0.2, bounds=(1,),
                     delta_m=(MP_STEPS,), lr=1e-3, gamma_averaging=0.01,
                     logit_clip=2.0)
    net_cfg = NetConfig(type="MLP", max_actions=3, width=256)
    log(f"model axis (a): phase 3's config (B = {B_MAIN}, MLP 256) through "
        f"RNaD on a 1 x 1 grid (one NCCL rank) and plain, one update period "
        f"of {MP_STEPS} steps and the final eval")
    grid = runtime.grid(1, "cuda")
    try:
        runs = {}
        for name, g in (("mp_grid", grid), ("mp_plain", None)):
            _zero_counts()
            runs[name] = rnad.RNaD(demo_tree, cfg, net_cfg,
                                   directory_name=name, seed=0,
                                   device="cuda", group=g)
            runs[name].run(log_mod=1)
            runs[name].final_eval()
            torch.cuda.synchronize()
            if name == "mp_grid":
                counts = _counts()
        want = {"k1": demo_tree.max_depth * MP_STEPS, "k2": 0, "k3": 0}
        if counts != want:
            raise AssertionError(f"model axis (a) launches {counts}, want "
                                 f"{want}")
        _assert_bitwise(runs["mp_grid"], _weights(runs["mp_plain"]),
                        "model axis (a)")
        evals = [[m["nashconv"] for _, m in r.history if "nashconv" in m]
                 for r in runs.values()]
        if evals[0] != evals[1] or not math.isfinite(evals[0][-1]):
            raise AssertionError(f"model axis (a) evals {evals}")
        calls = {}
        all_reduce = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            group = kwargs.get("group")
            axis = ("model" if group is grid.model.group else "data"
                    if group is grid.data.group else "world")
            calls[axis] = calls.get(axis, 0) + 1
            return all_reduce(tensor, *args, **kwargs)

        dist.all_reduce = counted
        try:
            runs["mp_grid"].train_step(runs["mp_grid"].state, 1.0)
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = all_reduce
        if calls != MP_COLLECTIVES["a"]:
            raise AssertionError(f"model axis (a): all-reduces {calls}, "
                                 f"want {MP_COLLECTIVES['a']}")
        times = _in_turns(list(runs), lambda name: runs[name].train_step(
            runs[name].state, 1.0))
        grid_ms, plain_ms = (min(times["mp_grid"]), min(times["mp_plain"]))
        log(f"model axis (a): launches {counts}; weights, target and the "
            f"final NashConv {evals[0][-1]:.7f} bitwise the plain run's; "
            f"all-reduces a step {calls}; back to back (best of 2 runs of "
            f"10, in turns): 1 x 1 grid {grid_ms:.4f} ms (runs "
            f"{times['mp_grid']}), plain {plain_ms:.4f} ms (runs "
            f"{times['mp_plain']}) | {card}")
        del runs

        # one rank's reports for (b) and (c), on this 1 x 1 grid
        demo_dir = checkpoint.save_tree(demo_tree, "mp_demo")
        spec_b = {"name": "b", "net": net_cfg.to_json(),
                  "rnad": cfg.to_json(), "tree_dir": demo_dir, "seed": 0,
                  "steps": MP_GLOO_STEPS}
        flag_dir = os.path.abspath(os.path.join("saved_trees", "flagship3"))
        noisy_dir = os.path.abspath(os.path.join("saved_trees", "noisyconv"))
        specs, cuts, launches = _mp_family_specs(flag_dir, noisy_dir)
        one = {spec["name"]: dryrun.run_spec(spec, grid)
               for spec in [spec_b] + specs}
    finally:
        runtime.shutdown()

    log(f"model axis (b): phase 3's config as model 2 on two gloo ranks "
        f"sharing the card, {MP_GLOO_STEPS} steps, against one rank")
    t0 = time.perf_counter()
    ranks = dryrun.spawn_specs(2, [spec_b], device="cuda", backend="gloo",
                               model_parallel=2, timeout=600)
    log(f"  two ranks: {time.perf_counter() - t0:.1f} s with the processes' "
        "start")
    k1 = {"k1": demo_tree.max_depth * MP_GLOO_STEPS, "k2": 0, "k3": 0}
    _check_against_one_rank("b", ranks, one["b"], MP_RTOL["b"], k1,
                            MP_COLLECTIVES["b"], card)
    counts_b = ranks[0]["runs"]["b"]["launches"]

    log(f"model axis (c): dryrun_multichip's families at full width as 4 "
        f"gloo ranks at data 2 x model 2, {MP_FAMILY_STEPS} steps each, "
        f"against one rank; cuts: " + "; ".join(f"{k} {v}"
                                                 for k, v in cuts.items()))
    t0 = time.perf_counter()
    ranks = dryrun.spawn_specs(4, specs, device="cuda", backend="gloo",
                               model_parallel=2, timeout=900)
    log(f"  four ranks: {time.perf_counter() - t0:.1f} s with the processes'"
        " start")
    counts_c = {"k1": 0, "k2": 0, "k3": 0}
    for spec in specs:
        name = spec["name"]
        _check_against_one_rank(name, ranks, one[name], MP_RTOL[name],
                                launches[name], MP_COLLECTIVES[name], card)
        for k, v in ranks[0]["runs"][name]["launches"].items():
            counts_c[k] += v
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return {"a": counts, "b": counts_b, "c": counts_c}


def curves_phase(card):
    """Phase 12 (a): the port's half of the curves for ``CURVES_SEED``
    against the committed halves; returns its launch counts."""
    import numpy as np

    from rnad_tpu_torch import validate_curves

    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "docs", "port_runs", "curves")
    name = f"curves-s{CURVES_SEED}"
    with open(os.path.join(committed, f"{name}.rnad_tpu.json")) as f:
        ref = json.load(f)
    argv = ["--seed", str(CURVES_SEED), "--out", "curves"]
    log("curves (a): python -m rnad_tpu_torch.validate_curves "
        + " ".join(argv) + " (tools/validate_vs_reference.py's defaults)")
    _zero_counts()
    rec = validate_curves.main(argv)
    counts = _counts()
    curve, want = rec["curve"], ref["curve"]
    steps = rec["options"]["updates"] * rec["options"]["delta_m"]
    log(f"curves (a): {rec['tree']['size']}-node tree, hash "
        f"{rec['tree']['hash']}, {steps} steps in {rec['wall_s']:.2f} s on "
        f"{rec['device']}; K1 {counts['k1']}, K2 {counts['k2']} launches")
    log("| update | rnad_tpu (committed, " + ref["device"] + ") | port |")
    for i, (a, b) in enumerate(zip(want, curve)):
        log(f"| {i} | {a:.6f} | {b:.6f} |")
    if rec["tree"]["hash"] != ref["tree"]["hash"]:
        raise AssertionError(f"curves: tree hash {rec['tree']['hash']}, "
                             f"committed {ref['tree']['hash']}")
    with np.load(os.path.join("curves", f"{name}.init.npz")) as got, \
            np.load(os.path.join(committed, f"{name}.init.npz")) as cm:
        if sorted(got.files) != sorted(cm.files) or not all(
                np.array_equal(got[k], cm[k]) for k in cm.files):
            raise AssertionError("curves: the initial weights differ from "
                                 "the committed ones")
    if not all(math.isfinite(v) for v in curve) or len(curve) != len(want):
        raise AssertionError(f"curves: evals {curve}")
    if not abs(curve[0] - want[0]) <= CURVES_ATOL:
        raise AssertionError(f"curves: update 0's NashConv {curve[0]} is "
                             f"{abs(curve[0] - want[0])} from rnad_tpu's "
                             f"{want[0]} (atol {CURVES_ATOL})")
    depth = rec["tree"]["max_depth"]
    if counts["k1"] != depth * steps or counts["k2"] or counts["k3"]:
        raise AssertionError(f"curves: launches {counts}, want K1 "
                             f"{depth * steps}, K2 0, K3 0")
    log(f"curves (a): update 0 within {abs(curve[0] - want[0]):.3g} of "
        f"rnad_tpu's (atol {CURVES_ATOL}); K1 {counts['k1'] / steps:g} and "
        f"K2 {counts['k2'] / steps:g} launches a step")
    return counts


def roofline_phase(card, demo_tree):
    """Phase 12 (b): ``profile_step.py``'s phases of the ``mlp`` config on
    phase 3's tree and of the ``offpol`` config on phase 5's stored tree,
    each beside its bound."""
    from rnad_tpu_torch import profile_step, roofline
    from rnad_tpu_torch.learn import buffer as buffer_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.utils import checkpoint

    trees = {"mlp": demo_tree,
             "offpol": checkpoint.load_tree("flagship3", device="cuda")}
    for net in ("mlp", "offpol"):
        _, net_cfg, cfg = profile_step.CONFIGS[net]
        run = rnad.RNaD(trees[net], cfg, net_cfg,
                        directory_name=f"roofline_{net}", device="cuda")
        run.initialize()
        buffer = None
        step_fn = lambda: run.train_step(run.state, 1.0)
        if profile_step._buffered(run):
            buffer = buffer_lib.TrajectoryBuffer(cfg.n_batches_per_buffer)
            step_fn = lambda: run.buffered_step(buffer, 1.0)
        for _ in range(2 * cfg.n_batches_per_buffer * cfg.buffer_mod):
            step_fn()  # warm-up; fills the buffer
        phases, counts = profile_step.phase_ms(run, buffer=buffer)
        rows, work = profile_step.roofline_rows(run, phases, counts)
        step = sum(phases.values())
        back_to_back = wall_ms(step_fn)
        log(f"roofline (b) {net}: B = {cfg.batch_size}, {net_cfg.width}-wide"
            f" MLP on a {run.tree.size}-node tree; distinct rows a rollout "
            f"{counts.rollout_rows:.1f}, cells {counts.rollout_cells:.1f}, "
            f"learner rows {counts.learner_rows:.1f} | {card}")
        for name, ms in phases.items():
            r = rows[name]
            log(f"  {name:40s} {ms:9.4f} ms; bound {r['bound_ms']:.6f} ms "
                f"({r['bound']}), {r['pct_of_roof']:.3f} % of it")
            if not 0.0 < r["pct_of_roof"] <= 100.0:
                raise AssertionError(f"roofline {net} {name}: share "
                                     f"{r['pct_of_roof']} %")
        whole = [roofline.annotate(work, t) for t in (step, back_to_back)]
        log(f"  step: bound {whole[0]['bound_ms']:.6f} ms "
            f"({whole[0]['bound']}; {whole[0]['gflops']:.6g} GFLOP, "
            f"{whole[0]['gbytes']:.6g} GB): {whole[0]['pct_of_roof']:.3f} % "
            f"of the {step:.4f} ms device time, {whole[1]['pct_of_roof']:.3f}"
            f" % of the {back_to_back:.4f} ms back-to-back time")
        del run, buffer
        torch.cuda.empty_cache()


def check_bf16_step_against_cpu(tree, cfg, net_cfg, B=256) -> None:
    """One train step with the bf16 actor at ``B`` lanes on the card (the
    bf16 K1, one launch a turn) and on the CPU (its plain version) from the
    same weights and noise: at most 2 % of the lanes part (near-ties of the
    bf16 band), the others equal; one learner step on the card's trajectory
    on both: losses within rtol 1e-5, weights within 1e-5.  The card tests
    run it too (tests/test_torch_cuda.py)."""
    import copy

    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import stepping

    small = dataclasses.replace(cfg, batch_size=B)
    A, T, md = tree.max_actions, tree.max_transitions, tree.max_depth
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(B, A, T, gen, "cpu") for _ in range(md)]
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
    states, packs, trajs = {}, {}, {}
    for device in ("cpu", "cuda"):
        states[device] = rnad.init_train_state(
            copy.deepcopy(net).to(device), torch.Generator(device=device))
        packs[device] = stepping.make_packed_tables(tree.to(device))
        before = fused_turn_lib.fused_turn.launches_bf16
        trajs[device] = rnad.rollout(states[device], tree.to(device),
                                     packs[device], small, noise)
        launched = fused_turn_lib.fused_turn.launches_bf16 - before
        if launched != (md if device == "cuda" else 0):
            raise AssertionError(f"bf16 actor on {device}: {launched} bf16 "
                                 f"K1 launches for {md} turns")
    tc, tg = trajs["cpu"], trajs["cuda"]
    parted = (tc.actions != tg.actions.cpu()).any(0)
    if parted.float().mean() > 0.02 or not all(
            torch.equal(getattr(tc, f)[:, ~parted],
                        getattr(tg, f).cpu()[:, ~parted])
            for f in ("indices", "actions", "rewards")):
        raise AssertionError(f"bf16 actor card vs CPU: {int(parted.sum())} "
                             "lanes part, or lanes whose actions agree")
    shared = engine.Trajectory(*(t.cpu() for t in (
        tg.indices, tg.policy, tg.actions, tg.rewards, tg.values)))
    mg = rnad.learn_step(states["cuda"], packs["cuda"], tg, 0.5, small)
    mc = rnad.learn_step(states["cpu"], packs["cpu"], shared, 0.5, small)
    for k in ("loss", "loss_v", "loss_nerd"):
        a, b = float(mc[k]), float(mg[k])
        if abs(a - b) > 1e-5 * max(abs(a), 1e-6):
            raise AssertionError(f"bf16 actor card vs CPU: {k} {b} vs {a}")
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(states["cuda"].net.parameters(),
                              states["cpu"].net.parameters()))
    if not err <= 1e-5:
        raise AssertionError(f"bf16 actor card vs CPU: weights differ by "
                             f"{err}")
    log(f"bf16 actor card vs CPU: one step at {B} lanes: {int(parted.sum())}"
        f" lanes parted at near-ties, the rest equal; learner on the card's "
        f"trajectory: loss {float(mg['loss']):.7f} (CPU "
        f"{float(mc['loss']):.7f}), weights max_abs_err {err:.3g}")


def check_learner_against_cpu(tree, cfg, net_cfg, card="cuda",
                              loss_rtol=1e-3) -> None:
    """One learner step at 256 lanes on one trajectory (rolled out on the
    card, copied to the CPU) on the card and on the CPU from the same
    weights: losses within ``loss_rtol``, new weights and statistics of the
    learner and the target within 2 lr (Adam with b1=0 moves a weight whose
    gradient is 0 but for rounding by up to lr either way) plus 1e-6 (the
    float32 rounding of the two updated weights).  A bfloat16 pass rounds
    its float32 sums to bfloat16, 2**-8 apart, and the card's libraries sum
    in another order than the CPU's, so some outputs part by one bfloat16
    ulp: 1e-3 holds the float32 nets' bfloat16 frozen passes, 1e-2 a net
    that computes in bfloat16 throughout (the ConvNet's step measured
    1.5e-3 on an NVIDIA H100)."""
    import copy

    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import stepping

    small = dataclasses.replace(cfg, batch_size=256)
    net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
    states, packs = {}, {}
    for key, device in (("cpu", "cpu"), ("card", card)):
        states[key] = rnad.init_train_state(
            copy.deepcopy(net).to(device), torch.Generator(device=device))
        packs[key] = stepping.make_packed_tables(tree.to(device))
    traj = rnad.rollout(states["card"], tree.to(card), packs["card"], small)
    cpu_traj = engine.Trajectory(*(None if t is None else t.cpu() for t in (
        traj.indices, traj.policy, traj.actions, traj.rewards, traj.values,
        traj.obs)))
    mg = rnad.learn_step(states["card"], packs["card"], traj, 0.5, small)
    mc = rnad.learn_step(states["cpu"], packs["cpu"], cpu_traj, 0.5, small)
    for k in ("loss", "loss_v", "loss_nerd"):
        a, b = float(mc[k]), float(mg[k])
        if abs(a - b) > loss_rtol * max(abs(a), 1e-6):
            raise AssertionError(f"{net_cfg.type} learner card vs CPU: {k} "
                                 f"{b} vs {a}")
    err = max(float((a.cpu() - b).abs().max()) for name in
              ("net", "net_target") for a, b in zip(
                  getattr(states["card"], name).state_dict().values(),
                  getattr(states["cpu"], name).state_dict().values()))
    if not err <= 2 * cfg.lr + 1e-6:
        raise AssertionError(f"{net_cfg.type} learner card vs CPU: weights "
                             f"differ by {err} > 2 lr")
    log(f"{net_cfg.type} (depth {net_cfg.depth}, {net_cfg.compute_dtype}, "
        f"frozen {cfg.frozen_net_dtype}) learner card vs CPU on one "
        f"trajectory: loss {float(mg['loss']):.7f} (CPU "
        f"{float(mc['loss']):.7f}, rtol {loss_rtol}), weights max_abs_err "
        f"{err:.3g} (2 lr = {2 * cfg.lr:.3g})")


def check_lift_against_cpu(tree, cfg, net_cfg) -> None:
    """One train step under the lift at the config's lanes on the card and
    on the CPU from the same weights and noise (the lift's eps included):
    equal episodes, stored observations within 1e-5, losses within rtol
    1e-4, new weights and BatchNorm statistics within 1e-4."""
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import obs_transform as obs_transform_lib
    from rnad_tpu_torch.ops import stepping

    B = cfg.batch_size
    A, T, md = tree.max_actions, tree.max_transitions, tree.max_depth
    gen = torch.Generator().manual_seed(3)
    channels = cfg.obs_transform.channels
    noise = [engine.turn_noise(B, A, T, gen, "cpu", channels)
             for _ in range(md)]
    out = {}
    for device in ("cpu", "cuda"):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        tf = rnad.resolve_obs_transform(net_cfg, dtree, cfg)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4),
                             obs_transform_lib.out_channels(cfg.obs_transform))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        traj = rnad.rollout(state, dtree, packed, cfg, noise, tf)
        metrics = rnad.learn_step(state, packed, traj, 0.5, cfg)
        out[device] = (traj, metrics, [t.detach().cpu() for name in
                                       ("net", "net_target") for t in
                                       getattr(state, name).state_dict()
                                       .values()])
    (tc, mc, pc), (tg, mg, pg) = out["cpu"], out["cuda"]
    for f in ("indices", "actions", "rewards"):
        if not torch.equal(getattr(tc, f), getattr(tg, f).cpu()):
            raise AssertionError(f"{net_cfg.type} lift card vs CPU: "
                                 f"trajectory {f} differ")
    obs_err = float((tc.obs - tg.obs.cpu()).abs().max())
    if not obs_err <= 1e-5:
        raise AssertionError(f"lift card vs CPU: stored obs differ by "
                             f"{obs_err}")
    for k in ("loss", "loss_v", "loss_nerd"):
        a, b = float(mc[k]), float(mg[k])
        if abs(a - b) > 1e-4 * max(abs(a), 1e-6):
            raise AssertionError(f"lift card vs CPU: {k} {b} vs {a}")
    err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    if not err <= 1e-4:
        raise AssertionError(f"{net_cfg.type} lift card vs CPU: weights or "
                             f"statistics differ by {err}")
    log(f"{net_cfg.type} lift card vs CPU: one step at {B} lanes agrees "
        f"(episodes equal, stored obs max_abs_err {obs_err:.3g}, weights and"
        f" statistics of the learner and the target max_abs_err {err:.3g}; "
        f"loss {float(mg['loss']):.6f}, CPU {float(mc['loss']):.6f})")


def check_step_against_cpu(tree, cfg, net_cfg, card="cuda",
                              atol=1e-4) -> None:
    """One train step at 256 lanes on the card (kernels) and on the CPU
    (plain versions) from the same weights and noise, for the EquiNet (and,
    in phase 8, the deep MLP and the bfloat16 ConvNet).  A lane's episode
    may part from the CPU's only at a near-tie: at the first half-step
    whose action differs, the CPU's two best scores (masked logits +
    Gumbel noise) lie within 1e-5, or within twice the largest difference
    between the card's and the CPU's scores of that lane (the primed
    logits are log x of the RM+ solve, and log magnifies the solves'
    float32 differences where x is near 0).  New weights within 1e-4 (two
    steps of lr = 5e-5: Adam with b1=0 turns a gradient that is 0 but for
    rounding into a step of up to lr either way)."""
    import copy

    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import common, nets
    from rnad_tpu_torch.ops import stepping

    B = 256
    small = dataclasses.replace(cfg, batch_size=B)
    A, T, md = tree.max_actions, tree.max_transitions, tree.max_depth
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(B, A, T, gen, "cpu") for _ in range(md)]
    out = {}
    for key, device in (("cpu", "cpu"), ("card", card)):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
        actor = copy.deepcopy(net).to(device)  # the rollout's weights
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        traj = rnad.rollout(state, dtree, packed, small, noise)
        metrics = rnad.learn_step(state, packed, traj, 0.5, small)
        out[key] = (
            traj, metrics, [p.detach().cpu() for p in state.net.parameters()],
            actor, packed)
    tc, tg = out["cpu"][0], out["card"][0]
    differ = tc.actions != tg.actions.cpu()  # (2 md, B)
    flipped = differ.any(0)
    lanes = torch.nonzero(flipped)[:, 0]
    if len(lanes):
        first = differ.to(torch.int32).argmax(0)[lanes]
        turn, seat = first // 2, first % 2
        idx = tc.indices[first, lanes]
        g = torch.stack([noise[int(t)][0][int(s) * B + int(b)]
                         for t, s, b in zip(turn, seat, lanes)])
        scores = {}
        for key, device in (("cpu", "cpu"), ("card", card)):
            _, _, _, actor, packed = out[key]
            rows = stepping.lookup(packed, idx.to(device))
            row_obs, col_obs = stepping.slice_observations(packed, rows)
            row_mask, col_mask = stepping.slice_action_masks(packed, rows)
            s = seat.to(device)
            obs = torch.where((s == 0)[:, None, None, None], row_obs, col_obs)
            mask = torch.where((s == 0)[:, None], row_mask, col_mask)
            with torch.no_grad():
                logits, _ = actor(obs)
            scores[key] = ((common.masked_logits(logits, mask)
                            + g.to(device)).cpu(), mask.cpu())
        (sc, mask), (sg, _) = scores["cpu"], scores["card"]
        top2 = sc.topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        diff = torch.where(mask > 0, (sg - sc).abs(),
                           torch.zeros_like(sc)).amax(1)
        near = gap < torch.clamp(2 * diff, min=1e-5)
        if not near.all():
            raise AssertionError(
                f"{net_cfg.type} card vs CPU: {int((~near).sum())} lanes part "
                f"without a near-tie (gaps {gap[~near].tolist()}, score "
                f"differences {diff[~near].tolist()})")
    keep = ~flipped
    for f in ("indices", "actions", "rewards"):
        if not torch.equal(getattr(tc, f)[:, keep],
                           getattr(tg, f).cpu()[:, keep]):
            raise AssertionError(f"{net_cfg.type} card vs CPU: {f} differ on lanes "
                                 "whose actions agree")
    pc, pg = out["cpu"][2], out["card"][2]
    err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    if not err <= atol:
        raise AssertionError(f"{net_cfg.type} card vs CPU: weights differ by {err} "
                             f"> {atol}")
    mc, mg = out["cpu"][1], out["card"][1]
    log(f"{net_cfg.type} ({net_cfg.compute_dtype}) card vs CPU: one step at {B} "
        f"lanes agrees: "
        f"{int(flipped.sum())} lanes parted, all at near-ties; weights "
        f"max_abs_err {err:.3g}; loss {float(mg['loss']):.6f} (CPU "
        f"{float(mc['loss']):.6f})")


def check_against_cpu(tree, cfg, net_cfg) -> None:
    """One fused train step at 256 lanes on the card (kernels) and on the
    CPU (plain versions) from the same weights and noise: equal episodes,
    losses within rtol 1e-4, new weights within 1e-4 (a tenth of the
    largest step Adam takes, lr)."""
    import dataclasses

    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import stepping

    small = dataclasses.replace(cfg, batch_size=256)
    A, T = tree.max_actions, tree.max_transitions
    gen = torch.Generator().manual_seed(3)
    noise = [engine.turn_noise(256, A, T, gen, "cpu")
             for _ in range(tree.max_depth)]
    out = {}
    for device in ("cpu", "cuda"):
        dtree = tree.to(device)
        packed = stepping.make_packed_tables(dtree)
        net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
        state = rnad.init_train_state(net.to(device),
                                      torch.Generator(device=device))
        traj = rnad.rollout(state, dtree, packed, small, noise)
        metrics = rnad.learn_step(state, packed, traj, 0.5, small)
        out[device] = (traj, metrics, [p.detach().cpu()
                                       for p in state.net.parameters()])
    (tc, mc, pc), (tg, mg, pg) = out["cpu"], out["cuda"]
    for f in ("indices", "actions", "rewards"):
        if not torch.equal(getattr(tc, f), getattr(tg, f).cpu()):
            raise AssertionError(f"card vs CPU step: trajectory {f} differ")
    for k in ("loss", "loss_v", "loss_nerd"):
        a, b = float(mc[k]), float(mg[k])
        if abs(a - b) > 1e-4 * max(abs(a), 1e-6):
            raise AssertionError(f"card vs CPU step: {k} {b} vs {a}")
    err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    if not err <= 1e-4:
        raise AssertionError(f"card vs CPU step: weights differ by {err}")
    log(f"card vs CPU: one train step at 256 lanes agrees (episodes equal, "
        f"weights max_abs_err {err:.3g})")


# phase 13: the benchmark programs.  bench.py's counterpart at its
# defaults, then tools/bench_suite.py's at 32768 lanes on three paths: the
# demo tree's MLP with the fused-turn row, the big tree with the bf16
# actor, the ConvNet
SUITE_RUNS = [["--batches", "32768", "--fused-turn"],
              ["--tree", "big", "--batches", "32768", "--actor-dtype",
               "bfloat16"],
              ["--net", "conv", "--batches", "32768"]]


def suite_rows(argv):
    """The metrics a bench_suite run of ``argv`` prints, in order."""
    from rnad_tpu_torch import bench_suite

    args = bench_suite.build_parser().parse_args(argv)
    fused = ["rollout_fused_turn_env_steps_per_s"] * args.fused_turn
    per_batch = (["rollout_env_steps_per_s"] + fused
                 + [m + s for s in ("", "_bf16")
                    for m in ("train_steps_per_s", "train_env_steps_per_s")])
    return (["tree_generation"] + per_batch * len(args.batches)
            + ["nashconv_eval"])


def suite_launches(argv, rows):
    """The launches of K1, the bf16 K1 and K2 that the code makes for a
    bench_suite run's rows, warm calls included.  A rollout of ``levels``
    turns launches ``levels`` of K1 (the float32 MLP, and every turn of
    the fused-turn row), of the bf16 K1 (the MLP under ``--actor-dtype
    bfloat16``) or of K2 (the generic turn: the ConvNet) for each of its
    ``lane_chunks``; a train step launches its rollout's (the bfloat16 MLP
    rolls out through the generic turn, since K1 computes in float32; the
    train rows keep the float32 actor) and no regather (the rollout stores
    the observations)."""
    from rnad_tpu_torch import bench, bench_suite

    conv = bench_suite.build_parser().parse_args(argv).net == "conv"
    levels = rows[0]["max_depth"]
    want = {"k1": 0, "k1_bf16": 0, "k2": 0}
    for r in rows:
        if r["metric"].startswith("rollout_"):
            calls = bench.WARM_ROLLOUTS + r["iters"]
            kernel = ("k2" if conv else "k1_bf16" if r.get("actor_dtype")
                      == "bfloat16" else "k1")
            want[kernel] += levels * calls * r.get("lane_chunks", 1)
        elif r["metric"].startswith("train_steps_per_s"):
            calls = bench.WARM_STEPS + r["iters"]
            generic = conv or r["dtype"] == "bfloat16"
            want["k2" if generic else "k1"] += levels * calls
    return want


def _bench_counts():
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib

    return {**_counts(), "k1_bf16": fused_turn_lib.fused_turn.launches_bf16}


def bench_phase(card):
    """Phase 13: ``rnad_tpu_torch.bench.main()`` at its defaults and
    ``bench_suite.main`` on ``SUITE_RUNS``, each with the launch counters
    zeroed just before and read just after and held to the code's count;
    every number finite and positive, every share of the bound in (0,
    100 %].  First K1 against its plain version at each of the bench's
    rollout batches, on its tree and actor; after the programs, one product
    step must make no synchronizing call, and last the device's idle share
    of the bench's rollouts.  Returns each program's launches."""
    import traceback
    import warnings

    from rnad_tpu_torch import bench, bench_suite
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import stepping

    t_phase = time.perf_counter()
    tree = tree_lib.generate_tree(bench.TREE_CONFIG, seed=0, device="cuda")
    turns = tree.max_depth
    packed = stepping.make_packed_tables(tree)
    A, T = tree.max_actions, tree.max_transitions
    S = packed.rows.shape[0]
    weights = [w.detach().contiguous()
               for w in nets.mlp_fused_weights(bench.actor_net("cuda"))]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for batch in bench.ROLLOUT_BATCHES:
        idx = torch.randint(0, S, (batch,), generator=gen, device="cuda",
                            dtype=torch.int32)
        g_act, g_ch = engine.turn_noise(batch, A, T, gen, "cuda")
        check_fused_turn(fused_turn_lib,
                         [packed.rows, *weights, idx, g_act, g_ch], A, T)
    del idx, g_act, g_ch
    _zero_counts()
    line = bench.main([])
    bench_got = _bench_counts()
    want = {"k1": turns * sum(bench.WARM_ROLLOUTS + bench.rollout_iters(b)
                              for b in bench.ROLLOUT_BATCHES),
            "k1_bf16": 0, "k2": turns * (bench.WARM_STEPS
                                         + bench.TRAIN_STEPS),
            "k3": 0}
    if bench_got != want:
        raise AssertionError(f"bench: launches {bench_got}, want {want} (K1 "
                             f"{turns} a rollout, K2 {turns} a step)")
    rates = [line["value"], line["train_updates_per_s"],
             line["train_env_steps_per_s"], *line["rollout_rates"].values()]
    keys = {"metric", "value", "unit", "rollout_batch", "rollout_rates",
            "train_updates_per_s", "train_env_steps_per_s", "device",
            "power_limit_w"}
    if set(line) != keys or not all(math.isfinite(r) and r > 0
                                    for r in rates) \
            or line["device"] != torch.cuda.get_device_name(0) \
            or not line["power_limit_w"] > 0:
        raise AssertionError(f"bench: line {line}")
    log(f"bench: self-checks held (lane diversity > 0, |mean return| <= 1, "
        f"finite losses); K1 {bench_got['k1']} ({turns} a rollout), K2 "
        f"{bench_got['k2']} ({turns} a step) as predicted; "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")

    # the product step must not wait for the device: each synchronizing
    # call is recorded with its innermost frame in the port; the mode is
    # set before the hook goes in, so only the step's own calls count
    state, train_step = bench.train_setup(tree, packed)
    train_step(state, bench.ALPHA)
    torch.cuda.synchronize()
    syncs = []

    def record(message, *args, **kw):
        port = [f for f in traceback.extract_stack()[:-1]
                if "rnad_tpu_torch" in f.filename]
        where = "outside the port"
        if port:
            path = port[-1].filename.split("rnad_tpu_torch")[-1]
            where = (f"rnad_tpu_torch{path}:{port[-1].lineno} "
                     f"({port[-1].name})")
        syncs.append(f"{where}: {str(message).splitlines()[0][:80]}")

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            train_step(state, bench.ALPHA)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if syncs:
        raise AssertionError(
            f"bench train step: {len(syncs)} synchronizing calls in one step"
            + "".join(f"\n  {w}" for w in sorted(set(syncs))))
    log("bench train step: no synchronizing call in one step")
    del state, train_step
    torch.cuda.empty_cache()

    suite = {"k1": 0, "k1_bf16": 0, "k2": 0}
    for argv in SUITE_RUNS:
        t0 = time.perf_counter()
        _zero_counts()
        rows = bench_suite.main(argv)
        got = _bench_counts()
        want = {**suite_launches(argv, rows), "k3": 0}
        log(f"bench_suite {' '.join(argv)}: {time.perf_counter() - t0:.1f} "
            f"s; launches {got}")
        if got != want:
            raise AssertionError(f"bench_suite {argv}: launches {got}, want "
                                 f"{want}")
        names = [r["metric"] for r in rows]
        if names != suite_rows(argv):
            raise AssertionError(f"bench_suite {argv}: rows {names}, want "
                                 f"{suite_rows(argv)}")
        mlp = bench_suite.build_parser().parse_args(argv).net == "mlp"
        for r in rows:
            if not (math.isfinite(r["value"]) and r["value"] > 0
                    and r["device"] == torch.cuda.get_device_name(0)):
                raise AssertionError(f"bench_suite {argv}: row {r}")
            roofed = mlp and r["metric"] not in ("tree_generation",
                                                 "nashconv_eval")
            if roofed != ("pct_of_roof" in r) or (
                    roofed and not 0.0 < r["pct_of_roof"] <= 100.0):
                raise AssertionError(f"bench_suite {argv}: share of the "
                                     f"bound in {r}")
        for k in suite:
            suite[k] += got[k]

    # the device's idle share of the bench's rollouts: their device time
    # behind a sleep over their time back to back
    net = bench.actor_net("cuda")
    for batch in bench.ROLLOUT_BATCHES:
        roll = bench.rollout_fn(tree, packed, net, batch, gen)
        busy_ms = device_ms(roll, iters=10)
        back_ms = wall_ms(roll)
        log(f"bench rollout, {batch} lanes: {busy_ms:.4f} ms device busy "
            f"behind a sleep, {back_ms:.4f} ms back to back "
            f"({100 * (1 - busy_ms / back_ms):.1f} % idle) | {card}")

    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"bench": bench_got, "suite": suite}


# phase 14: the learner step's options through the learner probe at its
# defaults (32768 lanes, width 256, the demo tree), cut to PROBE_ITERS
# timed steps a config; then f32/heads under both v-trace modes
PROBE_ITERS = 32
PROBE_ARGV = ["--batch", str(B_MAIN), "--width", "256", "--iters",
              str(PROBE_ITERS)]
PROBE_CUTS = [("--iters", str(PROBE_ITERS), "256")]
PROBE_VTRACE = ["--only", "f32/heads$", "--vtrace", "scan,associative"]
# the in-turns comparison: TURN_ROUNDS rounds of (variant, f32/heads,
# f32/heads, variant) windows of TURN_ITERS back-to-back steps each
TURN_ITERS, TURN_ROUNDS = 30, 2


def _tail_launches(cfg, state, grads):
    """Device operations (kernels, copies) of one clip + Adam + EMA tail
    (``rnad.apply_update``) in a profiler around that call alone, and
    their summed device ms."""
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.utils import timing

    torch.cuda.synchronize()
    with timing.trace() as prof:
        rnad.apply_update(cfg, state, grads)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in ops),
            sum(e.self_device_time_total for e in ops) / 1e3)


def learner_phase(card):
    """Phase 14: (a) ``learner_probe.main`` on its 8 configs (and
    f32/heads under both v-trace modes), the counters zeroed just before
    and read just after, each row's self-checks held by the probe and its
    launches a step held to the kernel table (K1 4 and K2 0 a float32 step;
    K1 0 and K2 4 a bfloat16 step: 4 generic turns, no regather); (b)
    one learner step with flat against the per-leaf step from the same
    state and trajectory, TF32 off: bitwise (weights, target, both
    moments); (c) the flat train steps against f32/heads back to back, in
    turns; (d) last, the device
    operations of one clip + Adam + EMA tail with and without flat, in a
    profiler around that call alone, and its device ms behind a sleep.
    Returns the launches of (a)."""
    from rnad_tpu_torch import learner_probe
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import stepping

    t_phase = time.perf_counter()
    log("learner probe: " + " ".join(PROBE_ARGV) + "; cuts: " + "; ".join(
        f"{f} {v} (the probe's default: {d})" for f, v, d in PROBE_CUTS))
    _zero_counts()
    rows = learner_probe.main(PROBE_ARGV)
    rows += learner_probe.main(PROBE_ARGV + PROBE_VTRACE)
    got = {**_counts(), "k1_bf16": fused_turn_lib.fused_turn.launches_bf16}
    tree = tree_lib.generate_tree(learner_probe.bench.TREE_CONFIG, seed=0,
                                  device="cuda")
    turns = tree.max_depth
    if len(rows) != 10 or got["k3"] or got["k1_bf16"]:
        raise AssertionError(f"learner probe: {len(rows)} rows, launches "
                             f"{got}")
    for r in rows:
        want = ((0.0, float(turns)) if r["config"].startswith("bf16")
                else (float(turns), 0.0))
        if (r["k1_per_step"], r["k2_per_step"]) != want:
            raise AssertionError(f"learner probe {r['config']}: launches a "
                                 f"step K1 {r['k1_per_step']}, K2 "
                                 f"{r['k2_per_step']}, want {want}")
        if not (math.isfinite(r["updates_per_s"]) and r["updates_per_s"] > 0
                and r["device"] == torch.cuda.get_device_name(0)
                and r["power_limit_w"] > 0
                and r["flat"] == ("flat" in r["config"])):
            raise AssertionError(f"learner probe: row {r}")
    log(f"learner probe: {len(rows)} rows, self-checks held; launches a "
        f"step as the kernel table says (K1 {turns}, K2 0 in float32; K1 0, "
        f"K2 {turns} in bfloat16); in all {got} | {card}")

    # (b) flat against the per-leaf step: one learner step from the same
    # state on the same trajectory
    packed = stepping.make_packed_tables(tree)
    base_cfg, net_cfg = learner_probe.configs(
        learner_probe.select("f32/heads$", None)[0], B_MAIN, 256,
        tree.max_actions)
    state = learner_probe.fresh_state(net_cfg, "cuda", learner_probe.NET_SEED)
    traj = rnad.rollout(learner_probe.clone_state(state), tree, packed,
                        base_cfg)
    probe = learner_probe.clone_state(state)
    loss, _ = rnad.learn_loss(probe, packed, traj, learner_probe.ALPHA,
                              base_cfg)
    grads = torch.autograd.grad(loss, list(probe.net.parameters()))

    def one_step(**kw):
        s = learner_probe.clone_state(state)
        cfg = dataclasses.replace(base_cfg, **kw)
        return s, rnad.learn_step(s, packed, traj, learner_probe.ALPHA, cfg)

    heads, _ = one_step()
    flat, _ = one_step(flat_optimizer=True)
    pairs = [("net", heads.net, flat.net),
             ("target", heads.net_target, flat.net_target)]
    same = all(torch.equal(p, q) for _, a, b in pairs
               for p, q in zip(a.parameters(), b.parameters()))
    same &= all(torch.equal(p, q) for p, q in zip(
        heads.opt.mu + heads.opt.nu, flat.opt.mu + flat.opt.nu))
    if not same or heads.opt.count != flat.opt.count:
        raise AssertionError("flat optimizer: not bitwise the per-leaf step")
    log("flat optimizer: one learner step bitwise the per-leaf step "
        "(weights, target, Adam's mu and nu)")
    del heads, flat, probe

    # (c) train steps back to back, flat against f32/heads in turns
    steps = {}
    for label in ("f32/heads", "f32/heads-flat"):
        cfg, _ = learner_probe.configs(learner_probe.select(
            label + "$", None)[0], B_MAIN, 256, tree.max_actions)
        st = learner_probe.clone_state(state)
        step = rnad.make_train_step(tree, packed, cfg)
        steps[label] = (lambda st=st, step=step:
                        step(st, learner_probe.ALPHA))
    for label in list(steps)[1:]:
        times = {label: [], "f32/heads": []}
        for _ in range(TURN_ROUNDS):
            for k, v in _in_turns((label, "f32/heads"),
                                  lambda n: steps[n](),
                                  iters=TURN_ITERS).items():
                times[k] += v
        ms = {k: "/".join(f"{t:.4f}" for t in v) for k, v in times.items()}
        ratio = sum(times["f32/heads"]) / sum(times[label])
        log(f"in turns, {TURN_ITERS} steps a window: {label} {ms[label]} "
            f"ms, f32/heads {ms['f32/heads']} ms ({ratio:.3f}x the updates/s"
            f" of f32/heads) | {card}")
    del steps

    # (d) the tail of one step, with and without flat (the profiler last:
    # its tracing slows the process's later launches)
    tails = {}
    for flat_opt in (False, True):
        cfg = dataclasses.replace(base_cfg, flat_optimizer=flat_opt)
        s = learner_probe.clone_state(state)
        ms = device_ms(lambda: rnad.apply_update(cfg, s, grads))
        tails[flat_opt] = (*_tail_launches(cfg, s, grads), ms)
    for flat_opt, (n, prof_ms, ms) in tails.items():
        if not n:
            raise AssertionError("the profiler recorded no device operation "
                                 "of the clip + Adam + EMA tail")
        log(f"clip + Adam + EMA, {'flat' if flat_opt else 'per leaf'}: {n} "
            f"device operations in one tail (profiler; {prof_ms:.4f} ms "
            f"summed there), {ms:.4f} ms device time behind a sleep | "
            f"{card}")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return got

# phase 15: the rollout's variants at the probe's width
ROLLOUT_LANES = 1 << 17  # the probe's default batch
ROLLOUT_CHUNKS = (2, 4)  # the K1 route's chunked rollouts, held bitwise
EQUI_CHUNKS = 4  # the generic turn's
ROLLOUT_PROBE_ARGV = ["--variants", "base,fused,chunk2,fused_chunk4"]


def check_obs_output(fused_turn_lib, args, A, T, label):
    """K1's stored-observation output on ``args`` against its plain
    version, bitwise; the launch with the output gives the other outputs
    of the launch without it, bitwise, and those are held to the plain
    version as phase 2 (float32) and phase 9 (bf16) hold them.  Returns
    the entry's numbers: the error, both launches' times and their
    bounds."""
    w0 = args[1]
    got = fused_turn_lib.fused_turn(*args, A=A, T=T, store_obs=True)
    torch.cuda.synchronize()
    want = fused_turn_lib.fused_turn_plain(*args, A=A, T=T, store_obs=True)
    if not torch.equal(got[5], want[5]):
        raise AssertionError(f"K1 {label}: the stored observations differ "
                             "from the packed rows' (plain version)")
    base = fused_turn_lib.fused_turn(*args, A=A, T=T)
    if not all(torch.equal(a, b) for a, b in zip(got[:5], base)):
        raise AssertionError(f"K1 {label}: the stored observations change "
                             "the turn's other outputs")
    if w0.dtype == torch.bfloat16:
        err = fused_turn_lib.check_bf16(base, args, A=A, T=T)["max_abs_err"]
        actions = base[2]
    else:
        err, _, actions = check_fused_turn(fused_turn_lib, args, A, T)
    out = {"max_abs_err_obs": float((got[5] - want[5]).abs().max()),
           "max_abs_err": err}
    for key, store in (("off", False), ("on", True)):
        out[f"ms_obs_{key}"] = device_ms(lambda: fused_turn_lib.fused_turn(
            *args, A=A, T=T, store_obs=store))
        out[f"bound_ms_obs_{key}"], by, _, nbytes = k1_bound_of(
            fused_turn_lib, args, actions, A, T, store)
        out[f"bytes_obs_{key}"] = nbytes
    out["bound_by"] = by
    log(f"K1 {label} ({args[5].shape[0]} lanes): stored observations "
        f"bitwise the plain version's, other outputs bitwise the launch "
        f"without them; {out['ms_obs_off']:.4f} ms without, "
        f"{out['ms_obs_on']:.4f} ms with "
        f"(+{out['ms_obs_on'] - out['ms_obs_off']:.4f} ms); bound "
        f"{out['bound_ms_obs_off']:.6f} -> "
        f"{out['bound_ms_obs_on']:.6f} ms ({by}; {out['bytes_obs_off']:.4g}"
        f" -> {out['bytes_obs_on']:.4g} B)")
    return out


def _first_parts(whole, other, noise, B):
    """Lanes whose actions differ between two rollouts of the same noise,
    and whether each first differs at a near-tie: the whole rollout's two
    best scores (log policy + Gumbel noise) there lie within 1e-5, or
    within twice the largest difference between the two rollouts' scores
    of that half-step (their recorded policies; the states agree up to
    it).  Returns (parted lanes, near-tie flags)."""
    differ = whole.actions != other.actions
    lanes = torch.nonzero(differ.any(0))[:, 0]
    if not len(lanes):
        return lanes, torch.ones(0, dtype=torch.bool)
    first = differ.to(torch.int32).argmax(0)[lanes]
    g = torch.stack([noise[int(t) // 2][0][int(t) % 2 * B + int(b)]
                     for t, b in zip(first, lanes)])
    log_p = lambda traj: torch.log(traj.policy[first, lanes])
    sw, so = log_p(whole) + g, log_p(other) + g
    legal = torch.isfinite(sw)
    top2 = sw.topk(2, dim=1).values
    diff = torch.where(legal, (so - sw).abs(),
                       torch.zeros_like(sw)).amax(1)
    return lanes, (top2[:, 0] - top2[:, 1]) < torch.clamp(2 * diff,
                                                          min=1e-5)


def rollout_phase(card, demo_tree, equi_tree):
    """Phase 15: the rollout's variants.  (a) K1's stored-observation
    output; (b) chunked rollouts against whole ones on the same full-batch
    noise; (c) train steps with and without stored observations; (d) the
    rollout probe, the counters zeroed just before and read just after.
    Returns the probe's launches."""
    from rnad_tpu_torch import bench, profile_step, rollout_probe
    from rnad_tpu_torch.config import NetConfig, RNaDConfig
    from rnad_tpu_torch.env import engine
    from rnad_tpu_torch.learn import rnad
    from rnad_tpu_torch.models import nets
    from rnad_tpu_torch.ops import fused_turn as fused_turn_lib
    from rnad_tpu_torch.ops import stepping
    from rnad_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    flag_tree = checkpoint.load_tree("flagship3", device="cuda")
    # (a) the output at phase 3's shape (A = 3) and the offpol one (A = 5)
    entries = {}
    for tree in (demo_tree, flag_tree):
        packed = stepping.make_packed_tables(tree)
        A, T = tree.max_actions, tree.max_transitions
        net = nets.MLP(A, 256, generator=torch.Generator().manual_seed(1))
        fused = [w.detach().contiguous()
                 for w in nets.mlp_fused_weights(net.to("cuda"))]
        idx = torch.randint(0, tree.size, (B_MAIN,), generator=gen,
                            device="cuda", dtype=torch.int32)
        g_act, g_ch = engine.turn_noise(B_MAIN, A, T, gen, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            w = [fused[0].to(dtype).contiguous(), fused[1],
                 fused[2].to(dtype).contiguous(), fused[3]]
            label = f"A={A} {str(dtype).split('.')[-1]}"
            entries[label] = check_obs_output(
                fused_turn_lib, [packed.rows, *w, idx, g_act, g_ch], A, T,
                label)
    del flag_tree

    # (b) chunked against whole on the same noise: the K1 route bitwise
    packed = stepping.make_packed_tables(demo_tree)
    A, T, md = (demo_tree.max_actions, demo_tree.max_transitions,
                demo_tree.max_depth)
    mlp = nets.MLP(A, 256, generator=torch.Generator().manual_seed(2)).to(
        "cuda")
    init = torch.ones((ROLLOUT_LANES,), dtype=torch.int32, device="cuda")
    noise = [engine.turn_noise(ROLLOUT_LANES, A, T, gen, "cuda")
             for _ in range(md)]
    roll = lambda **kw: engine.rollout_from(demo_tree, packed, mlp, init,
                                            noise=noise, rows_actor="on",
                                            store_obs=True, **kw)
    fields = ("indices", "policy", "actions", "rewards", "values", "obs")
    same = lambda a, b: all(torch.equal(getattr(a, f), getattr(b, f))
                            for f in fields)
    whole = roll()
    for k in ROLLOUT_CHUNKS:
        if not same(roll(lane_chunks=k), whole):
            raise AssertionError(f"K1 route: {k} lane chunks part from the "
                                 "whole rollout on the same noise")
    log(f"rollout variants, K1 route ({ROLLOUT_LANES} lanes, MLP 256): "
        f"{ROLLOUT_CHUNKS} lane chunks bitwise the whole rollout on the same"
        f" noise")
    del whole, noise

    # (b) the generic turn: phase 4's solver EquiNet, its weights moved off
    # the primed zero heads so every layer counts
    packed = stepping.make_packed_tables(equi_tree)
    A, T, md = (equi_tree.max_actions, equi_tree.max_transitions,
                equi_tree.max_depth)
    pgen = torch.Generator().manual_seed(3)
    equi = nets.build_net(NetConfig(type="EquiNet", max_actions=A,
                                    channels=64, depth=2,
                                    solver_iters=RM_ITERS,
                                    solver_prime=True), pgen)
    with torch.no_grad():
        for p_ in equi.parameters():
            p_.add_(0.05 * torch.randn(p_.shape, generator=pgen))
    equi = equi.to("cuda")
    noise = [engine.turn_noise(ROLLOUT_LANES, A, T, gen, "cuda")
             for _ in range(md)]
    trajs, peaks = {}, {}
    for k in (1, EQUI_CHUNKS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trajs[k] = engine.rollout_from(equi_tree, packed, equi, init,
                                       noise=noise, store_obs=True,
                                       lane_chunks=k)
        torch.cuda.synchronize()
        peaks[k] = torch.cuda.max_memory_allocated() / 2**30
    whole, chunked = trajs[1], trajs[EQUI_CHUNKS]
    lanes, near = _first_parts(whole, chunked, noise, ROLLOUT_LANES)
    if not near.all():
        raise AssertionError(f"generic turn: {int((~near).sum())} lanes of "
                             f"{EQUI_CHUNKS} chunks part from the whole "
                             "rollout without a near-tie")
    keep = torch.ones(ROLLOUT_LANES, dtype=torch.bool, device="cuda")
    keep[lanes] = False
    for f in ("indices", "actions", "rewards", "obs"):
        if not torch.equal(getattr(whole, f)[:, keep],
                           getattr(chunked, f)[:, keep]):
            raise AssertionError(f"generic turn: {f} differ on lanes whose "
                                 "actions agree")
    err = max(float((getattr(whole, f)[:, keep]
                     - getattr(chunked, f)[:, keep]).abs().max())
              for f in ("policy", "values"))
    if not err <= 1e-5:
        raise AssertionError(f"generic turn: policy/values of {EQUI_CHUNKS}"
                             f" chunks off by {err} > 1e-5")
    log(f"rollout variants, generic turn (solver EquiNet 64x2 s{RM_ITERS}p,"
        f" A={A}, {ROLLOUT_LANES} lanes): {EQUI_CHUNKS} lane chunks against "
        f"the whole rollout on the same noise: {len(lanes)} lanes parted, "
        f"all at near-ties; policy/values max_abs_err {err:.3g} (atol "
        f"1e-5); peak device memory {peaks[1]:.3f} GiB whole, "
        f"{peaks[EQUI_CHUNKS]:.3f} GiB in {EQUI_CHUNKS} chunks | {card}")
    del trajs, whole, chunked, equi, noise, init
    torch.cuda.empty_cache()

    # (c) one train step with and without stored observations, bitwise
    flag_tree = checkpoint.load_tree("flagship3", device="cuda")
    steps = {"MLP (phase 3)": (demo_tree, NetConfig(
                 type="MLP", max_actions=demo_tree.max_actions, width=256),
                 RNaDConfig(batch_size=B_MAIN, eta=0.2, lr=1e-3,
                            gamma_averaging=0.01, logit_clip=2.0)),
             "flagship-3": (flag_tree, *profile_step.CONFIGS["flagship"][1:])}
    for name, (tree, net_cfg, cfg) in steps.items():
        packed = stepping.make_packed_tables(tree)
        noise = [engine.turn_noise(B_MAIN, tree.max_actions,
                                   tree.max_transitions, gen, "cuda")
                 for _ in range(tree.max_depth)]
        got = {}
        for store in (True, False):
            c = dataclasses.replace(cfg, store_rollout_obs=store)
            net = nets.build_net(net_cfg, torch.Generator().manual_seed(4))
            state = rnad.init_train_state(net.to("cuda"),
                                          torch.Generator(device="cuda"))
            _, metrics, traj = rnad.make_train_step(tree, packed, c)(
                state, 0.5, noise, with_trajectory=True)
            got[store] = ([t.detach().clone() for t in
                           (*state.net.state_dict().values(),
                            *state.net_target.state_dict().values())],
                          metrics, traj.obs is not None)
            del state, traj
        (w_on, m_on, stored), (w_off, m_off, _) = got[True], got[False]
        if not stored or not (
                all(torch.equal(a, b) for a, b in zip(w_on, w_off))
                and m_on.keys() == m_off.keys()
                and all(torch.equal(m_on[k], m_off[k]) for k in m_on)):
            raise AssertionError(f"{name}: the step with stored observations "
                                 "is not bitwise the regather step")
        log(f"store_rollout_obs {name}: one train step stores the "
            f"observations and is bitwise the regather step (weights, "
            f"target, {len(m_on)} metrics; loss {float(m_on['loss']):.6f})")
        del got, noise
        torch.cuda.empty_cache()
    del flag_tree

    # (d) the rollout probe at its defaults on the given variants
    log(f"rollout probe: {' '.join(ROLLOUT_PROBE_ARGV)} (the probe's default"
        f" batch {ROLLOUT_LANES} and iterations)")
    _zero_counts()
    rows = rollout_probe.main(ROLLOUT_PROBE_ARGV)
    torch.cuda.synchronize()
    got = {**_counts(), "k1_bf16": fused_turn_lib.fused_turn.launches_bf16}
    md = demo_tree.max_depth
    calls = rollout_probe.ITERS + bench.WARM_ROLLOUTS
    fused = sum(rollout_probe.parse(r["variant"])[1] for r in rows
                if rollout_probe.parse(r["variant"])[0])
    generic = sum(rollout_probe.parse(r["variant"])[1] for r in rows
                  if not rollout_probe.parse(r["variant"])[0])
    want = {"k1": md * calls * fused, "k2": md * calls * generic, "k3": 0,
            "k1_bf16": 0}
    if got != want:
        raise AssertionError(f"rollout probe: launches {got}, want {want}")
    for r in rows:
        per = md * r["lane_chunks"]
        fused_row = rollout_probe.parse(r["variant"])[0]
        if ((r["k1_per_rollout"], r["k2_per_rollout"])
                != ((per, 0) if fused_row else (0, per))
                or not abs(r["mean_return"]) <= 1.0
                or not (math.isfinite(r["half_steps_per_s"])
                        and r["half_steps_per_s"] > 0)
                or r["device"] != torch.cuda.get_device_name(0)
                or not r["power_limit_w"] > 0):
            raise AssertionError(f"rollout probe row {r}")
    rates = {r["variant"]: r["half_steps_per_s"] for r in rows}
    log("rollout probe: self-checks held (lane diversity > 0, |mean "
        "return| <= 1); " + ", ".join(
            f"{k} {v:.6g} half-steps/s ({v / rates['base']:.3f}x base, peak "
            f"{r['peak_mem_gib']:.3f} GiB)" for (k, v), r in zip(rates.items(),
                                                              rows))
        + f"; launches {got} | {card}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return {"k1": got["k1"], "k2": got["k2"], "obs": entries}


if __name__ == "__main__":
    sys.exit(main())
