"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (its file of sizes
under ``benchmark/configs/``) and a traffic mix (``benchmark/traffic/
<traffic>.json``).  The run builds the port's ``RNaD`` for them (the
tree, the weights and the rollout noise made from the seed), drives its
first train steps and reads them for the check, warms up, and then calls
``RNaD.train_step`` back to back for ``--seconds``: the measured window.
With ``--trace 1`` the same window is followed by a few steps under
``torch.profiler``, with spans around the rollout and the learner step.
After that the program's state is freed and the plain reference
(``benchmark/reference/``) follows the same first steps from the same
inputs; ``check.py`` compares the two.  Those phases are the traffic
kind's driver's (``benchmark/drivers/<kind>.py``, the kind the traffic
file names; ``drivers/train.py`` is the one described here).

Each metric is read by its own file, ``benchmark/metrics/<name>.py``: the
cell's end-to-end metrics without the trace, its per-layer metrics with
it.  The last line of standard output is one JSON object; the numbers
compared, each beside its limit, end standard error and the line.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with 3 and prints no result; if JAX or the JAX package is loaded at the
end, with 4.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the package, not this directory, so that no file here shadows a module
sys.path[0] = str(ROOT)
CACHE = HERE / ".cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))

from benchmark import cells  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cells.find(args.workload)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 3

    from benchmark import check, system, trace as trace_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limit_w = power_limit()
    driver = cell.driver
    sut = driver.build(cell, args.seed)
    got = driver.checked(sut, cell)
    driver.warm(sut, cell)
    torch.cuda.synchronize()
    ctx = cells.Context(cell, sut)
    ctx.setup_s = time.perf_counter() - _START
    ctx.window = driver.window(sut, args.seconds)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "power_limit": limit_w}
    breakdown = None
    if args.trace:
        with tempfile.TemporaryDirectory(prefix="rnad-bench-trace-") as d:
            path = os.path.join(d, "trace.json")
            ctx.rollouts, traced_s = driver.traced(sut, cell, path)
            ctx.trace = trace_lib.read(path, cell.traffic["trace_steps"])
        device.update(busy_s=ctx.trace.busy_s, window_s=traced_s)
        top = sorted(ctx.trace.by_name.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:160], s] for n, s in top],
                     "idle_gaps": [list(g) for g in ctx.trace.gaps]}
    device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    inputs = sut.inputs
    window = ctx.window
    system.free(sut)
    del sut

    want = driver.reference(cell, inputs, got, "cuda")
    correct, table = check.judge(driver.numbers(cell, got, want, "cuda"),
                                 check.limits(cell.name))
    loaded = system.forbidden_loaded(sys.modules)
    if loaded:
        print(f"loaded in the measuring process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": window.steps,
              "failed": window.nonfinite, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    made = "generated" if ctx.tree_generated else "loaded"
    print(f"{cell.name} seed {args.seed} on {device['kind']} ({limit_w}); "
          f"tree {made} in {ctx.tree_s:.2f} s", file=sys.stderr)
    print("\n".join(check.lines(table)), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
