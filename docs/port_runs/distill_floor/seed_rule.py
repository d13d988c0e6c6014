"""The distillation floor's seed rule: rnad_tpu_torch against rnad_tpu.

Both packages distill the exact solution of ``examples/eta_sweep.py``'s demo
tree (A = 3, seeds 0-4, one tree a seed, which both packages hash alike)
into a width-256 depth-1 MLP, full batch, 2000 Adam steps at lr 1e-3, on
the CPU: rnad_tpu with ``tools/distill_floor.py --cpu --tree demo-s<k>
--net MLP:256 --steps 2000 --node-batch 0 --seed k``, the port with
``python -m rnad_tpu_torch.distill_floor`` and the same options.  The
inits differ by design (each package's own generator); the seeds average
over that.

F is a run's floor NashConv; d_k = F_port - F_rnad_tpu.  The floors agree
when |mean d| <= max(3 * sd(d) / sqrt(5), 0.02), sd with ddof 1.

    python docs/port_runs/distill_floor/seed_rule.py run
    python docs/port_runs/distill_floor/seed_rule.py

``run`` runs the ten distillations and writes ``seed_rule.jsonl`` here;
without arguments the script prints the rule's table from that file.
"""

import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[2]
SEEDS = range(5)
ARGS = ["--cpu", "--net", "MLP:256", "--steps", "2000", "--node-batch", "0"]
RESULTS = HERE / "seed_rule.jsonl"


def run():
    sys.path.insert(0, str(REPO))
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.eta_sweep import DEMO_TREE
    from rnad_tpu_torch.utils import checkpoint

    env = dict(os.environ, PYTHONPATH=str(REPO))
    lines = []
    with tempfile.TemporaryDirectory(prefix="seed_rule_") as cwd:
        for k in SEEDS:
            tree = tree_lib.generate_tree(DEMO_TREE, seed=k, device="cpu")
            checkpoint.save_tree(tree, f"demo-s{k}", root=os.path.join(
                cwd, "saved_trees"), desc=DEMO_TREE.desc,
                config_json=DEMO_TREE.to_json())
            argv = ARGS + ["--tree", f"demo-s{k}", "--seed", str(k)]
            for package, cmd in (
                    ("rnad_tpu", [sys.executable,
                                  str(REPO / "tools" / "distill_floor.py")]),
                    ("port", [sys.executable, "-m",
                              "rnad_tpu_torch.distill_floor"])):
                out = subprocess.run(cmd + argv, cwd=cwd, env=env,
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise SystemExit(f"{package} seed {k}: {out.stderr}")
                floor = json.loads(out.stdout.strip().splitlines()[-1])
                line = dict(floor, seed=k, package=package,
                            tree_hash=tree.hash)
                lines.append(line)
                print(json.dumps(line), flush=True)
    with open(RESULTS, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")


def table():
    lines = [json.loads(x) for x in RESULTS.open()]
    F = {(x["package"], x["seed"]): x["floor_nashconv"] for x in lines}
    rnad = np.array([F["rnad_tpu", k] for k in SEEDS])
    port = np.array([F["port", k] for k in SEEDS])
    d = port - rnad
    sd = float(np.std(d, ddof=1))
    bound = max(3 * sd / math.sqrt(len(d)), 0.02)
    print("seed  F rnad_tpu  F port     d")
    for k, a, b in zip(SEEDS, rnad, port):
        print(f"{k:4d}  {a:.6f}  {b:.6f}  {b - a:+.6f}")
    print(f"mean  {rnad.mean():.6f}  {port.mean():.6f}  {d.mean():+.6f}; "
          f"sd(d) {sd:.6f}, bound {bound:.6f}: "
          f"{'agree' if abs(d.mean()) <= bound else 'DO NOT AGREE'}")


if __name__ == "__main__":
    if sys.argv[1:] == ["run"]:
        run()
    table()
