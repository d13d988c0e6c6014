"""The program's own spans in a ``torch.profiler`` chrome trace.

While a profiler records, the port opens a span at each of its layers'
boundaries (``rnad_tpu_torch/utils/timing.py::span``; every name begins
``rnad.``: ``rnad.train_step``, ``rnad.rollout``, ``rnad.learn`` and its
passes ``rnad.learn.forward``, ``.frozen``, ``.vtrace``, ``.backward``,
``.allreduce``, ``.update``).  ``read`` ties each device operation, by
the correlation id of the host call that launched it, to every program
span open at that launch, as ``trace.py`` ties it to the harness's spans:

* ``program_s``: device seconds of the operations launched inside each
  span, by name, summed over all the name's intervals;
* ``idle_s``: the idle gap before each operation launched inside each
  span, by name: a gap counts under every program span open at the
  launch of the operation that ends it;
* ``idle_total_s``: every idle gap between the traced operations;
* ``by_name``: each span's device seconds by operation name.

A trace of a program without the spans reads empty dictionaries.

Run as a script on a card, it measures one cell's traced steps (its
traffic kind's ``traced`` phase, the harness spans included) with the
program's spans and without them (``span`` patched to a null context), in
turns, and prints one JSON line a traced window: its host seconds, the
harness's ``rollout_ms`` and ``learn_ms``, kernels a step, and each span's
device and idle milliseconds a step::

    python3 -m benchmark.program_spans --workload <cell> --seed <n> \
        [--rounds 2]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from typing import Dict, List, Tuple

from benchmark.trace import DEVICE_CATS

PREFIX = "rnad."


@dataclasses.dataclass
class ProgramSpans:
    """Sums over the traced steps, in seconds."""

    steps: int
    program_s: Dict[str, float]
    idle_s: Dict[str, float]
    idle_total_s: float
    by_name: Dict[str, Dict[str, float]]


def _open_at(spans: List[Tuple[float, float, str]], ts: float):
    return {name for start, end, name in spans if start <= ts <= end}


def read(path: str, steps: int) -> ProgramSpans:
    """The program spans of a trace of ``steps`` traced steps."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, device, spans = {}, [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            device.append(e)
        elif (cat in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})):
            launches[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    program_s, idle_s, by_name = {}, {}, {}
    idle_total = 0.0
    end = None
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        gap = start - end if end is not None and start > end else 0.0
        idle_total += gap
        end = stop if end is None else max(end, stop)
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        dur = e["dur"] * 1e-6
        for name in _open_at(spans, ts):
            program_s[name] = program_s.get(name, 0.0) + dur
            ops = by_name.setdefault(name, {})
            ops[e["name"]] = ops.get(e["name"], 0.0) + dur
            if gap:
                idle_s[name] = idle_s.get(name, 0.0) + gap * 1e-6
    return ProgramSpans(steps, program_s, idle_s, idle_total * 1e-6,
                        by_name)


@contextlib.contextmanager
def _spans_off():
    """The program's ``span`` as a null context (a program without it is
    left as it is)."""
    from rnad_tpu_torch.utils import timing

    saved = getattr(timing, "span", None)
    if saved is not None:
        timing.span = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        if saved is not None:
            timing.span = saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    from benchmark import cells
    from benchmark import trace as trace_lib
    from benchmark.run import power_limit

    cell = cells.find(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)} ({power_limit()})"
    phases = cell.driver
    sut = phases.build(cell, args.seed)
    for _ in range(cell.traffic["checked_steps"]):
        sut.step()
    phases.warm(sut, cell)
    steps = cell.traffic["trace_steps"]
    for r in range(args.rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            with tempfile.TemporaryDirectory(prefix="rnad-spans-") as d:
                path = os.path.join(d, "trace.json")
                with contextlib.nullcontext() if on else _spans_off():
                    _, seconds = phases.traced(sut, cell, path)
                t = trace_lib.read(path, steps)
                p = read(path, steps)
            ms = lambda s: 1e3 * s / steps
            print(json.dumps({
                "workload": cell.name, "seed": args.seed, "round": r,
                "spans": on, "card": card, "window_s": seconds,
                "kernels_per_step": t.kernels / steps,
                "busy_ms": ms(t.busy_s), "idle_total_ms": ms(p.idle_total_s),
                "rollout_ms": ms(t.span_s.get("rollout", 0.0)),
                "learn_ms": ms(t.span_s.get("learn_step", 0.0)),
                "program_ms": {k: ms(v) for k, v in
                               sorted(p.program_s.items())},
                "idle_ms": {k: ms(v) for k, v in sorted(p.idle_s.items())},
                "top_ops_ms": {span: [[n[:240], ms(s)] for n, s in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:5]]
                    for span, ops in sorted(p.by_name.items())}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
