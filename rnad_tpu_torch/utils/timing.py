"""Profiling helpers (the counterpart of ``rnad_tpu/utils/timing.py``).

- ``PhaseTimer``: named wall-clock phases that synchronise the phase's
  device at the end of each phase, so the device work a phase queued is
  attributed to it and not to the next one.
- ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
  card, of its kernels; written as a Chrome trace under ``log_dir`` where
  one is given.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional, Union

import torch

_Sync = Union[None, torch.Tensor, torch.device, str]


def _synchronize(sync: _Sync) -> None:
    """Waits for the CUDA device of ``sync`` (a tensor or a device); a CPU
    one, or None, needs no wait."""
    if sync is None:
        return
    device = sync.device if isinstance(sync, torch.Tensor) else \
        torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: _Sync = None):
        """Times the block as ``name``; at its end, waits for the device
        of ``sync`` (a tensor or a device) before reading the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Waits for ``value``'s device and attributes the wait to
        ``name``."""
        with self.phase(name, sync=value):
            pass
        return value

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block, yielding the profiler (read its
    ``key_averages()``); records the card's kernels where CUDA is
    available, and writes ``<log_dir>/trace.json`` (open it in
    chrome://tracing or Perfetto) where ``log_dir`` is given."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
