"""Multi-process data-parallel check (the counterpart of
``tools/multiprocess_check.py``).

Spawns N processes (``rnad_tpu_torch/mp_worker.py``) that form one
``torch.distributed`` group over localhost and run the global-stream step
on their slices of the lanes (the fused on-policy step, or the buffered
step with ``--n-batches-per-buffer`` / ``--buffer-mod``; an MLP, or the
ConvNet or EquiNet with ``--net``, under the lift with ``--obs-lift``), and
holds the per-step losses and the final parameter checksum against a
one-process run of the same seed: the run samples the same episodes
whatever the rank count (``parallel/runtime.py``), so the numbers agree up
to summation order.  It runs on the card (NCCL) unless ``--cpu`` asks for
the CPU (gloo); ranks that share one card need ``--backend gloo``, since
NCCL refuses two ranks on one card.

    python -m rnad_tpu_torch.multiprocess_check --cpu            # 2 ranks
    python -m rnad_tpu_torch.multiprocess_check --cpu --num-processes 4 \\
        --net ConvNet --channels 8 --net-depth 2 --obs-lift 8
    python -m rnad_tpu_torch.multiprocess_check --backend gloo   # one card,
                                                  # ranks sharing it

Every child has a time limit; a rank that fails or hangs fails the check
and the others are killed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

from .parallel.runtime import free_port

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def spawn(num_processes: int, worker_args: Sequence[str], timeout: float,
          *, device: str, backend: Optional[str] = None,
          module: str = "rnad_tpu_torch.mp_worker") -> List[dict]:
    """Runs ``num_processes`` ranks of ``python -m module`` on ``device``
    ("cuda" or "cpu"; each told its ``--process-id``, ``--num-processes``,
    ``--port``, ``--cpu`` on the CPU and ``--backend`` where given) to
    their end; returns the JSON object each printed last.  Raises if a
    rank fails or passes ``timeout`` seconds."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="1")
    # files, not pipes: a rank never blocks on output nobody reads yet
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(num_processes)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", module,
         "--process-id", str(i), "--num-processes", str(num_processes),
         "--port", str(port), *(["--cpu"] if device == "cpu" else []),
         *(["--backend", backend] if backend else []),
         *worker_args], env=env, stdout=out, stderr=err, text=True)
        for i, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for i, (proc, (out, err)) in enumerate(zip(procs, logs)):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {i} passed the {timeout} s limit")
            out.seek(0)
            err.seek(0)
            if proc.returncode != 0:
                raise RuntimeError(f"rank {i} exited {proc.returncode}:\n"
                                   f"{err.read()[-4000:]}")
            results.append(json.loads(out.read().strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out, err in logs:
            out.close()
            err.close()
    return results


def run_cluster(num_processes: int, steps: int, batch_size: int, seed: int,
                *, device: str, backend: Optional[str] = None,
                timeout: float = 600, run_dir: Optional[str] = None,
                save: bool = False, resume: bool = False,
                width: int = 32, tree_dir: Optional[str] = None,
                traj_out: Optional[str] = None, net: str = "MLP",
                channels: int = 16, net_depth: int = 1,
                obs_lift: Optional[int] = None, obs_noise_sigma: float = 0.1,
                n_batches_per_buffer: int = 1, buffer_mod: int = 1) -> dict:
    """Runs ``num_processes`` ranks of the global-stream step (the
    buffered one where ``n_batches_per_buffer`` or ``buffer_mod`` > 1) for
    ``steps`` steps on ``device``; returns rank 0's result with ``ranks``,
    every rank's (their ``param_digest`` agree when the weights and
    BatchNorm statistics stayed replicated)."""
    args = ["--steps", str(steps), "--batch-size", str(batch_size),
            "--seed", str(seed), "--width", str(width), "--net", net,
            "--channels", str(channels), "--net-depth", str(net_depth),
            "--obs-noise-sigma", str(obs_noise_sigma),
            "--n-batches-per-buffer", str(n_batches_per_buffer),
            "--buffer-mod", str(buffer_mod)]
    for flag, value in (("--run-dir", run_dir), ("--tree-dir", tree_dir),
                        ("--traj-out", traj_out), ("--obs-lift", obs_lift)):
        if value is not None:
            args += [flag, str(value)]
    args += ["--save"] * save + ["--resume"] * resume
    ranks = spawn(num_processes, args, timeout, device=device,
                  backend=backend)
    return dict(ranks[0], ranks=ranks)


def run_single(steps: int, batch_size: int, seed: int, **kw) -> dict:
    """The same-seed one-process reference (a one-rank group)."""
    return run_cluster(1, steps, batch_size, seed, **kw)


def run_resume_across(procs_a: int, steps_a: int, procs_b: int,
                      steps_b: int, batch_size: int, seed: int,
                      **kw) -> tuple:
    """A checkpoint saved by ``procs_a`` ranks after ``steps_a`` steps,
    resumed by ``procs_b`` ranks for ``steps_b`` more: checkpoints hold no
    per-rank state, so the continued run does not depend on the rank
    count.  Returns both phases' results."""
    with tempfile.TemporaryDirectory(prefix="mpresume_") as root:
        run_dir = os.path.join(root, "run")
        phase1 = run_cluster(procs_a, steps_a, batch_size, seed,
                             run_dir=run_dir, save=True, **kw)
        phase2 = run_cluster(procs_b, steps_b, batch_size, seed,
                             run_dir=run_dir, resume=True, **kw)
    return phase1, phase2


def run_nashconv(num_processes: int, tree_dir: str, policy: str, out: str,
                 *, device: str, backend: Optional[str] = None,
                 timeout: float = 600) -> dict:
    """The node-sharded NashConv of the stored tree ``tree_dir`` under the
    joint policy ``policy`` (.npy) over ``num_processes`` ranks; rank 0's
    per-node values go to ``out`` (.npz).  Returns rank 0's result with
    ``ranks``."""
    ranks = spawn(num_processes, ["--task", "nashconv", "--tree-dir",
                                   tree_dir, "--policy", policy, "--out",
                                   out], timeout, device=device,
                   backend=backend)
    return dict(ranks[0], ranks=ranks)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--cpu", dest="device", action="store_const",
                   const="cpu", default="cuda",
                   help="run on the CPU instead of the card")
    p.add_argument("--backend", default=None,
                   help="nccl on the card, gloo on the CPU by default")
    p.add_argument("--net", choices=["MLP", "ConvNet", "EquiNet"],
                   default="MLP")
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--net-depth", type=int, default=1)
    p.add_argument("--obs-lift", type=int, default=None, metavar="C")
    p.add_argument("--n-batches-per-buffer", type=int, default=1)
    p.add_argument("--buffer-mod", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    kw = dict(device=args.device, backend=args.backend, net=args.net,
              channels=args.channels, net_depth=args.net_depth,
              obs_lift=args.obs_lift,
              n_batches_per_buffer=args.n_batches_per_buffer,
              buffer_mod=args.buffer_mod)
    multi = run_cluster(args.num_processes, args.steps, args.batch_size,
                        args.seed, **kw)
    single = run_single(args.steps, args.batch_size, args.seed, **kw)
    print(f"multi : {multi['num_processes']} ranks on {multi['device']}; "
          f"losses {multi['losses']}")
    print(f"single: losses {single['losses']}")
    ok = all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
             for a, b in zip(multi["losses"], single["losses"]))
    dsum = abs(multi["param_checksum"] - single["param_checksum"])
    ok = ok and dsum <= 1e-4 * abs(single["param_checksum"])
    ok = ok and len({r["param_digest"] for r in multi["ranks"]}) == 1
    print(f"param checksum: multi {multi['param_checksum']:.6f} single "
          f"{single['param_checksum']:.6f} (|diff| {dsum:.2e}); weights "
          f"equal on every rank: "
          f"{len({r['param_digest'] for r in multi['ranks']}) == 1}")
    print("MULTIPROCESS CHECK:", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
