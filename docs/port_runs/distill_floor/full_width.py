"""The distillation floors of flagship-3's tree at full width.

Generates flagship-3's tree (docs/runs/r4-flagship3.params.json: the
native generator's A = 5, depth-6 tree of seed 0, 785,768 nodes, hash
-3582253928252745740) into ``saved_trees/flagship3`` under a temporary
working directory, then runs the distillation tool on it, as
docs/SCALE.md's floor table was run with ``tools/distill_floor.py``:

    python docs/port_runs/distill_floor/full_width.py [--out DIR]

runs ``python -m rnad_tpu_torch.distill_floor`` on the card for
``EquiNet:64x2s128p`` (flagship-3's net) at 3000 x 8192, ``MLP:512x3`` at
10000 x 8192 and ``RM+:2000``, each in its own process, and writes their
JSON lines, with the card's name and power limit, to ``DIR/floors.jsonl``
(default ``distill_floor_out`` under the working directory).

    python docs/port_runs/distill_floor/full_width.py --rnad-tpu-skyline

runs ``tools/distill_floor.py --cpu --net RM+:2000`` (rnad_tpu, on the
CPU) on the same tree instead and writes ``DIR/rnad_tpu_skyline.jsonl``.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[3]
HASH, NODES = -3582253928252745740, 785768
RUNS = [["--net", "EquiNet:64x2s128p", "--steps", "3000", "--node-batch",
         "8192"],
        ["--net", "MLP:512x3", "--steps", "10000", "--node-batch", "8192"],
        ["--net", "RM+:2000"]]


def make_tree(cwd):
    sys.path.insert(0, str(REPO))
    from rnad_tpu_torch.config import ShapingRule, TreeConfig
    from rnad_tpu_torch.env import tree as tree_lib
    from rnad_tpu_torch.utils import checkpoint

    cfg = TreeConfig(max_actions=5, max_transitions=2,
                     transition_threshold=0.25, depth_bound=6,
                     depth_bound_rule=ShapingRule(-1, -2, 0.55))
    tree = tree_lib.generate_tree_native(cfg, seed=0, device="cpu")
    if (tree.size, tree.hash) != (NODES, HASH):
        raise SystemExit(f"flagship tree: {tree.size} nodes, hash "
                         f"{tree.hash}")
    checkpoint.save_tree(tree, "flagship3", root=os.path.join(
        cwd, "saved_trees"), config_json=cfg.to_json())


def run(cmd, cwd):
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)}: exit {out.returncode}")
    return [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="distill_floor_out")
    ap.add_argument("--rnad-tpu-skyline", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="floors_") as cwd:
        make_tree(cwd)
        if args.rnad_tpu_skyline:
            lines = run([sys.executable, str(REPO / "tools"
                                             / "distill_floor.py"),
                         "--cpu", "--tree", "flagship3", "--net", "RM+:2000"],
                        cwd)
            name = "rnad_tpu_skyline.jsonl"
        else:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            lines = []
            for argv in RUNS:
                got = run([sys.executable, "-m",
                           "rnad_tpu_torch.distill_floor", "--tree",
                           "flagship3", *argv], cwd)
                lines += got[1:] if lines else got
                print(json.dumps(lines[-1]), flush=True)
            lines = [dict(line, card=card) for line in lines]
            name = "floors.jsonl"
    with open(os.path.join(args.out, name), "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print("\n".join(json.dumps(x) for x in lines))


if __name__ == "__main__":
    main()
