"""NashConv curves of rnad_tpu_torch against rnad_tpu on the run of
``tools/validate_vs_reference.py`` (the same tree, the same initial MLP,
the same hyperparameters), and the seed rule over them.

    python -m rnad_tpu_torch.validate_curves --seed k --out DIR   # the port
    python docs/port_runs/curves/validate_vs_rnad_tpu.py rnad_tpu NAME [--dir DIR]
    python docs/port_runs/curves/validate_vs_rnad_tpu.py both --cpu [options]
    python docs/port_runs/curves/validate_vs_rnad_tpu.py compare [--dir DIR]

The port's half (``rnad_tpu_torch/validate_curves.py``) runs on the card
and writes ``NAME.port.json`` and the initial weights ``NAME.init.npz``.
``rnad_tpu`` runs its half on the CPU: it regenerates the tree with
``rnad_tpu.env.tree.generate_tree`` from the options the port's record
holds (or loads the same reference tree), checks that its hash is the
port's, loads the weights and calls the JAX tool's own ``run_ours``
unchanged, then writes ``NAME.rnad_tpu.json``.  ``both`` runs the port's
half (its options passed on; ``--cpu`` puts it on the CPU) and then
``rnad_tpu``'s.  ``compare`` prints the JAX tool's side-by-side table of
each pair in ``--dir`` (default: this directory), each half's wall
seconds under its own device (no ratio: the halves ran on different
machines), and the seed rule of ``docs/port_runs/eta_sweep/seed_rule.py``
on these curves: for each seed F is the mean of the last 4 evals, d =
F_port - F_rnad_tpu, and the curves agree when |mean d| <= max(3 sd(d) /
sqrt(n), 0.02) over the n seeds (sd with ddof 1).  It exits 1 when they do
not agree, and 2 when a pair is missing a half or the pairs ran other
options.

Seeds 0-4 at the defaults are filed here: the port's half on one H100,
``rnad_tpu``'s on the CPU.
"""

import argparse
import json
import math
import os
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

LAST, Z, FLOOR = 4, 3.0, 0.02  # the seed rule's F window, its z and floor


def load_params(path) -> dict:
    """The initial MLP's ``{layer: {leaf: array}}`` flax params from the
    port's ``.init.npz`` (``<layer>/<leaf>`` arrays)."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            params.setdefault(layer, {})[leaf] = z[key]
    return params


def run_rnad_tpu(name: str, directory: pathlib.Path) -> dict:
    """``rnad_tpu``'s half of the pair ``name`` in ``directory``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rnad_tpu.config import ShapingRule, TreeConfig
    from rnad_tpu.env import tree as tree_lib
    from rnad_tpu.utils import checkpoint
    from tools import validate_vs_reference as tool

    port = json.loads((directory / f"{name}.port.json").read_text())
    opts = port["options"]
    if opts["reference_tree"]:
        tree = checkpoint.load_reference_tree(opts["reference_tree"])
    else:
        rule = (ShapingRule(delta=-1, stochastic_delta=-2,
                            stochastic_prob=0.5)
                if opts["stochastic_depth"] else ShapingRule(delta=-1))
        tree = tree_lib.generate_tree(
            TreeConfig(max_actions=3, max_transitions=2,
                       transition_threshold=0.3, depth_bound=opts["depth"],
                       depth_bound_rule=rule), seed=opts["seed"])
    if int(tree.hash) != port["tree"]["hash"]:
        raise SystemExit(f"{name}: rnad_tpu's tree hashes to {tree.hash}, "
                         f"the port's to {port['tree']['hash']}")
    params = load_params(directory / port["init"])
    t0 = time.perf_counter()
    curve = tool.run_ours(tree, params, opts["updates"], opts["delta_m"],
                          opts["batch_size"], opts["eta"], opts["lr"],
                          opts["gamma_avg"], opts["seed"])
    record = {"name": name,
              "tree": {"hash": int(tree.hash), "size": int(tree.size),
                       "max_depth": int(tree.max_depth)},
              "options": opts, "curve": curve,
              "wall_s": time.perf_counter() - t0,
              "device": (f"{jax.devices()[0].device_kind} "
                         f"({os.cpu_count()} cores)"),
              "jax": jax.__version__}
    (directory / f"{name}.rnad_tpu.json").write_text(
        json.dumps(record, indent=1) + "\n")
    return record


def pairs(directory: pathlib.Path):
    """[(port record, rnad_tpu record)] of every ``*.port.json`` in
    ``directory``, by name; exits 2 when a half is missing, the trees
    differ, or the pairs ran other options (beyond the seed)."""
    out = []
    for path in sorted(directory.glob("*.port.json")):
        name = path.name[:-len(".port.json")]
        other = directory / f"{name}.rnad_tpu.json"
        if not other.exists():
            raise SystemExit(f"{name}: no rnad_tpu half ({other.name})")
        port = json.loads(path.read_text())
        ref = json.loads(other.read_text())
        if port["tree"]["hash"] != ref["tree"]["hash"]:
            raise SystemExit(f"{name}: the halves ran different trees")
        out.append((port, ref))
    orphans = (sorted(p.name for p in directory.glob("*.rnad_tpu.json"))
               != sorted(f"{p['name']}.rnad_tpu.json" for p, _ in out))
    if orphans:
        raise SystemExit(f"{directory}: an rnad_tpu half has no port half")
    if not out:
        raise SystemExit(f"{directory}: no curves")
    shared = lambda rec: {k: v for k, v in rec["options"].items()
                          if k != "seed"}
    if any(shared(p) != shared(out[0][0]) or p["options"] != r["options"]
           for p, r in out):
        raise SystemExit("the pairs ran other options")
    return out


def seed_rule(found) -> dict:
    """The rule over the pairs ``found``: F, d, mean d, sd(d), the bound
    and whether the curves agree."""
    if len(found) < 2:
        raise SystemExit("the seed rule needs two seeds or more")
    f_ref = np.array([np.mean(r["curve"][-LAST:]) for _, r in found])
    f_port = np.array([np.mean(p["curve"][-LAST:]) for p, _ in found])
    d = f_port - f_ref
    sd = float(d.std(ddof=1))
    bound = max(Z * sd / math.sqrt(len(d)), FLOOR)
    return {"f_rnad_tpu": f_ref, "f_port": f_port, "d": d,
            "mean_d": float(d.mean()), "sd": sd, "bound": bound,
            "agrees": abs(float(d.mean())) <= bound}


def compare(directory: pathlib.Path) -> bool:
    found = pairs(directory)
    for port, ref in found:
        print(f"\n{port['name']}: seed {port['options']['seed']}, tree hash "
              f"{port['tree']['hash']} ({port['tree']['size']} nodes, depth "
              f"{port['tree']['max_depth']})")
        print(f"  port: {port['wall_s']:.1f} s on {port['device']} (K1 "
              f"{port['k1_per_step']:g}, K2 {port['k2_per_step']:g} "
              f"launches a step); rnad_tpu: {ref['wall_s']:.1f} s on "
              f"{ref['device']}")
        print("| update | rnad_tpu | port | abs d |")
        print("| --- | --- | --- | --- |")
        for i, (a, b) in enumerate(zip(ref["curve"], port["curve"])):
            print(f"| {i} | {a:.6f} | {b:.6f} | {abs(b - a):.6f} |")
    rule = seed_rule(found)
    n = len(found)
    print(f"\nseed rule over {n} seeds: F = mean of the last {LAST} evals, "
          f"d = F_port - F_rnad_tpu, agree when |mean d| <= max({Z:g} "
          f"sd(d)/sqrt({n}), {FLOOR})")
    print("| seed | F rnad_tpu | F port | d |")
    print("| --- | --- | --- | --- |")
    for (port, _), a, b, d in zip(found, rule["f_rnad_tpu"], rule["f_port"],
                                  rule["d"]):
        print(f"| {port['options']['seed']} | {a:.6f} | {b:.6f} | "
              f"{d:+.6f} |")
    print(f"mean d {rule['mean_d']:+.6f}, sd(d) {rule['sd']:.6f}, bound "
          f"{rule['bound']:.6f}: {'agree' if rule['agrees'] else 'DISAGREE'}")
    return rule["agrees"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["both"]:
        from rnad_tpu_torch import validate_curves

        port = validate_curves.main(argv[1:])
        out = validate_curves.build_parser().parse_args(argv[1:]).out
        run_rnad_tpu(port["name"], pathlib.Path(out))
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    one = sub.add_parser("rnad_tpu", help="rnad_tpu's half of one pair")
    one.add_argument("name")
    one.add_argument("--dir", default=str(HERE))
    cmp_ = sub.add_parser("compare", help="the table and the seed rule")
    cmp_.add_argument("--dir", default=str(HERE))
    sub.add_parser("both", help="the port's half (its options follow), "
                                "then rnad_tpu's")
    args = parser.parse_args(argv)
    if args.command == "rnad_tpu":
        run_rnad_tpu(args.name, pathlib.Path(args.dir))
        return 0
    return 0 if compare(pathlib.Path(args.dir)) else 1


if __name__ == "__main__":
    sys.exit(main())
