"""Reads a ``torch.profiler`` chrome trace into what the per-layer
metrics need.

Each device operation (a kernel, copy or fill) is tied to the host call
that launched it by the trace's correlation id, and through that call's
time to the harness spans (``train_step``, ``rollout``, ``learn_step``)
and the innermost host operation open at the launch.  From that:
device time by span and by kernel name, kernels launched, the union of
busy intervals, and the idle gaps between them, each named by what the
host was doing when it launched the operation that ended the gap.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("train_step", "rollout", "learn_step")


@dataclasses.dataclass
class Trace:
    """Sums over the traced steps, in seconds."""

    steps: int
    kernels: int
    busy_s: float
    span_s: Dict[str, float]  # device time of operations launched inside
    by_name: Dict[str, float]  # device time by operation name
    launches: Dict[str, int]  # launches by operation name
    gaps: List[Tuple[str, float]]  # the longest idle gaps, named

    def kernel_s(self, fragment: str) -> float:
        """Device time of the operations whose name holds ``fragment``."""
        return sum(s for name, s in self.by_name.items() if fragment in name)

    def kernel_launches(self, fragment: str) -> int:
        return sum(n for name, n in self.launches.items() if fragment in name)


def _innermost(intervals, ts: float):
    """The innermost of ``intervals`` (sorted (start, end, name), nested)
    that contains ``ts``."""
    best = None
    i = bisect.bisect_right(intervals, (ts, float("inf"), ""))
    for start, end, name in reversed(intervals[max(0, i - 64):i]):
        if start <= ts <= end and (best is None or start >= best[0]):
            best = (start, end, name)
    return best


def read(path: str, steps: int) -> Trace:
    """The trace of ``steps`` traced train steps."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, device, spans, ops = {}, [], [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            device.append(e)
        elif (cat in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})):
            launches[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e["name"] in SPANS:
            spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat == "cpu_op":
            ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    spans.sort()
    ops.sort()
    span_s = defaultdict(float)
    by_name = defaultdict(float)
    counts = defaultdict(int)
    kernels = 0
    device.sort(key=lambda e: e["ts"])
    for e in device:
        dur = e["dur"] * 1e-6
        by_name[e["name"]] += dur
        counts[e["name"]] += 1
        kernels += e.get("cat") == "kernel"
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for start, end, name in spans:
            if start <= ts <= end:
                span_s[name] += dur
    busy, gaps = 0.0, []
    end = None
    for e in device:
        start, stop = e["ts"], e["ts"] + e["dur"]
        if end is not None and start > end:
            gaps.append((start - end, e))
        if end is None or start > end:
            busy += e["dur"]
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    gaps.sort(key=lambda g: -g[0])
    named = []
    for gap, e in gaps[:10]:
        ts = launches.get(e.get("args", {}).get("correlation"))
        where = "no launch"
        if ts is not None:
            span = _innermost(spans, ts)
            op = _innermost(ops, ts)
            where = (f"{span[2] if span else 'outside train_step'}: "
                     f"{op[2] if op else 'python'}")
        named.append((where, gap * 1e-6))
    return Trace(steps, kernels, busy * 1e-6, dict(span_s), dict(by_name),
                 dict(counts), named)
